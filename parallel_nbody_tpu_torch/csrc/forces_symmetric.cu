// Symmetric all-pairs forces for Hopper (sm_90a): the square fp32 case of K1
// and K2 with each unordered pair evaluated once.
//
// Replaces no TPU kernel of its own.  It serves the square case of K1
// (csrc/forces.cu, which replaces pallas_step.py::_force_kernel) and, past
// 131072 bodies, of K2 (csrc/forces_streamed.cu) where the row block and
// the column block are the same bodies at the same offsets, the compute
// type is float32 (fp32 or bf16 storage) and the sum is plain:
// ops/cuda_step.takes_symmetric decides it from what the call shows.  K1 takes
// every ordered pair (N^2) and applies each pair's force to its row body
// only; the reference (nbody-seq.c) applies each pair's force to both
// bodies, N(N-1)/2 pairs.  Here one evaluation gives both terms: with
// w = rsqrt(forced^2 * dsqr + eps),
//
//   acc_i += (m_j * w) * dx_ij          (K1's term for row i, column j)
//   acc_j -= (m_i * w) * dx_ij          (K1's term for row j, column i)
//
// and the second is K1's own term for the pair (j, i) bit for bit before it
// is summed: the dx bias is antisymmetric (K1's segments, pairs.cuh: -C on
// column tiles wholly below the 128-row block, +C wholly above, (gj - gi) * P
// where they overlap; with equal offsets the blocks and tiles coincide), so
// the biased dx_ji = (xi - xj) + b_ji is exactly -dx_ij in float, dy_ji is
// -dy_ij, and dsqr, forced and w are the pair's own.  Only the order of
// summation changes.  No fast math: rsqrt_t is pairs.cuh's bare MUFU on an
// argument that is never below FLT_MIN, and every product and sum is fp32.
//
// Layout.  The bodies are cut into tiles of kTile = 512 (the ragged last tile
// staged with zero-mass bodies at the origin, whose terms are exactly 0;
// bodies past n are neither read nor written).  One block of 64 threads
// takes one tile pair (I, J), J >= I, of a triangular 1-D grid
// (nt (nt + 1) / 2 blocks for nt tiles).  Each thread holds eight row bodies
// of I in registers (rows t + 64 q, q = 0..7; rows 64 q .. 64 q + 63 lie in
// one 128-row block); J's bodies are staged once in shared memory and read
// by broadcast LDS.128, as K1 reads its column tiles.
//   - Off the diagonal (J > I; every pair's bias is +C for the row of I):
//     for each 8-column pass, every thread sums its eight rows' j-side terms
//     for each column in registers (8 pairs of accumulators), and the warp
//     folds them across its 32 lanes by a register reduce-scatter (lane bits
//     4, 2, 1: a select pair, a shuffle and an add per value kept; then
//     shuffles and adds across lanes 8 and 16 apart), leaving column l % 8's
//     sum over the warp's 256 rows in lane l.  Lanes 0-7 store it to shared
//     memory at [warp][column]; after the sweep the block adds its two
//     warps' sums in warp order.  A row's i-side terms run term by term in
//     registers over each 128-column block of J, and the four blocks' sums
//     are added in order in shared memory, as K1 folds its tile partials.
//   - On the diagonal (I == J): K1's one-sided sweep (pairs.cuh's
//     sweep_segment, with K1's segments of the bias) of each row over the
//     tile's four 128-column blocks, block by block; no j-side terms.  That
//     is 2 / (nt + 1) of the pairs evaluated twice, 1.6% at N = 65536.
//   The sizes were measured against their neighbours on the H100 (PERF.md):
//   more rows a thread fold the j-side sums over more pairs, and a 512-body
//   tile halves the workspace of 256 at a small cost in the last wave.
// Output: the raw accelerations (before G * m_i) go to a (nt, 2, n) fp32
// workspace, slot [K][c][b] holding body b's sum over tile K's bodies: the
// block (I, J) writes its i-side sums to [J][.][i] and, off the diagonal,
// its j-side sums to [I][.][j].  Each slot has exactly one writer, and
// nothing is added with atomics, so two launches on the same inputs give the
// same bits.  forces_streamed.cu's band_fold_kernel then adds each body's nt
// slots in tile order 0..nt-1 and multiplies by G * m_i (storing bf16 once).
// ops/cuda_step.symmetric_partials is this order in plain PyTorch.  The
// workspace is 8 N^2 / 512 bytes: 64 MiB at N = 65536, 256 MiB at 131072,
// 16 GiB at 1M.
//
// Row launches (symmetric_rows_kernel and symmetric_fold_kernel; above
// 131072 bodies, ops/cuda_step.symmetric_forces): the same blocks, each
// computing what it computes in one launch, restricted to the row tiles
// t0 .. t1 - 1 (the triangle of those tiles, then the rectangle of column
// tiles past t1).  Their slots go to two workspaces (RowSlots): `own`, the
// launch's bodies' slots K = t0 .. nt - 1, and `beyond`, the j-side slots
// K = t0 .. t1 - 1 of the bodies past the launch: at most R N / 32 bytes
// for R rows, so 32768 rows a launch fit 1 GiB at N = 1M.  The fold adds
// them to a running (2, n) fp32 sum.  Over ascending ranges of row tiles,
// a body of tile T receives its slots in tile order: the j-side slots of
// earlier launches in ascending K, then in its own launch the j-side slots
// K = t0 .. T - 1 and its i-side slots K = T .. nt - 1.  So each sum is
// band_fold_kernel's chain over the one-launch workspace, and the forces
// are the one launch's bit for bit whatever the rows of a launch.
// ops/cuda_step.symmetric_forces_reference is this in plain PyTorch.
//
// Bound: instruction issue, as K1's loop, at this loop's own count per
// unordered pair (benchmarks/sass_census.py; 64 pairs a pass: 8 columns by
// eight rows).  Per pair: 15 FP32 (3 FADD, 5 FMUL, 6 FFMA, 1 FMNMX; the
// first row's j-side product is an FMUL in place of an FFMA; 16 with the
// bias), one MUFU.RSQ, an eighth of an LDS.128 (a load of one of the four
// staged arrays serves four columns of eight rows), and the reduce-scatter,
// 64 instructions a pass for both components, 1.0 a pair.  The census of
// the H100 build: 17.86 instructions per unordered pair unbiased, 18.86
// with the constant bias; K1 takes 15.0 per ordered pair, 30 per unordered
// pair.
//
// The coincident-pair flag is read from device memory (a 0-d bool tensor
// written by ops/cuda_step.any_coincident) once per block, uniformly across
// the grid, as K1 reads it.
//
// Build: as forces.cu (ops/_build.py; no --use_fast_math, no -ftz).

#include "pairs.cuh"

namespace {

using nbody::Consts;
using nbody::kBlock;

constexpr int kThreads = 64;  // threads per block
constexpr int kRows = 8;      // row bodies per thread
constexpr int kTile = kRows * kThreads;  // bodies per tile
constexpr int kWarps = kThreads / 32;
constexpr int kSub = 8;  // columns per register pass
constexpr int kBlocksPerTile = kTile / kBlock;
static_assert(kTile % kBlock == 0, "tiles are whole 128-body blocks");
static_assert(kThreads % 32 == 0 && (kBlock % kThreads == 0 ||
                                     kThreads % kBlock == 0),
              "a warp's rows q * kThreads + t share a 128-row block");
static_assert(kSub <= 32 && (kSub & (kSub - 1)) == 0, "kSub: 1, 2, .. 32");
// Blocks an SM should hold at once, so that ptxas keeps each thread's
// registers within 65536 / 512.
constexpr int kMinBlocks = 512 / kThreads;
// Threads per block of the row launches' fold.
constexpr int kFoldThreads = 256;

// Block b of the triangular grid -> its tile pair (ti, tj), tj >= ti,
// enumerated column tile first: b = tj (tj + 1) / 2 + ti.
__device__ __forceinline__ void tile_pair(long long b, long long& ti,
                                          long long& tj) {
  long long j = static_cast<long long>(
      (sqrt(8.0 * static_cast<double>(b) + 1.0) - 1.0) * 0.5);
  while (j * (j + 1) / 2 > b) --j;
  while ((j + 1) * (j + 2) / 2 <= b) ++j;
  tj = j;
  ti = b - j * (j + 1) / 2;
}

// Fold 2 * kHalf values per lane to kHalf: a lane whose bit kHalf is set
// keeps the upper half and sends the lower to its partner, which keeps the
// lower half.  The partners add the same two values, in either order, so the
// sum does not depend on the lane.
template <int kHalf>
__device__ __forceinline__ void fold_half(float* v, bool upper) {
#pragma unroll
  for (int k = 0; k < kHalf; ++k) {
    const float send = upper ? v[k] : v[k + kHalf];
    const float keep = upper ? v[k + kHalf] : v[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, kHalf);
  }
}

template <int kN>
__device__ __forceinline__ void fold_columns(float* v, int lane) {
  if constexpr (kN > 1) {
    fold_half<kN / 2>(v, lane & (kN / 2));
    fold_columns<kN / 2>(v, lane);
  }
}

// v[0..kSub) per lane -> v[0] in lane l: the sum over the warp's 32 lanes of
// column l % kSub.  The halving folds leave each lane one column summed
// over its group of kSub lanes; the butterfly adds the groups.
__device__ __forceinline__ void reduce_scatter(float* v, int lane) {
  fold_columns<kSub>(v, lane);
#pragma unroll
  for (int o = kSub; o < 32; o *= 2) {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
  }
}

// Row q of a thread's register array, q not known at compile time.
__device__ __forceinline__ float pick(const float (&v)[kRows], int q) {
  float out = v[0];
#pragma unroll
  for (int k = 1; k < kRows; ++k) out = q == k ? v[k] : out;
  return out;
}

// The tile pair off the diagonal: every pair once, both terms.  Each row
// sums each 128-column block of J term by term into ax, ay, and the blocks'
// sums are added in order in tix/tiy [row] (shared memory, one slot a row:
// no registers), as K1 folds its 128-column tile partials; the rows' sums
// come back in ax, ay.  The columns' sums of each warp go to redx/redy
// [warp * kTile + column].
template <bool kBiased>
__device__ __forceinline__ void sweep_pairs(
    const float* __restrict__ sx, const float* __restrict__ sy,
    const float* __restrict__ sm, const float* __restrict__ sr,
    const float (&xi)[kRows], const float (&yi)[kRows],
    const float (&mi)[kRows], const float (&ri)[kRows], float (&ax)[kRows],
    float (&ay)[kRows], float* __restrict__ tix, float* __restrict__ tiy,
    float* __restrict__ redx, float* __restrict__ redy) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll 1
  for (int b = 0; b < kTile; b += kBlock) {
#pragma unroll 1
    for (int s = b; s < b + kBlock; s += kSub) {
      float bx[kSub], by[kSub];
#pragma unroll
      for (int t = 0; t < kSub; ++t) {
        const float xj = sx[s + t], yj = sy[s + t];
        const float mj = sm[s + t], rj = sr[s + t];
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          float dx = xj - xi[q];
          if (kBiased) dx = dx + Consts<float>::cbias;
          const float dy = yj - yi[q];
          const float dsqr = dx * dx + dy * dy;
          const float mind = ri[q] + rj;
          const float forced = max(dsqr, mind * mind);
          const float w =
              nbody::rsqrt_t(forced * forced * dsqr + Consts<float>::eps);
          const float sj = mj * w;
          const float si = mi[q] * w;
          ax[q] += sj * dx;
          ay[q] += sj * dy;
          if (q == 0) {
            bx[t] = -(si * dx);
            by[t] = -(si * dy);
          } else {
            bx[t] -= si * dx;
            by[t] -= si * dy;
          }
        }
      }
      reduce_scatter(bx, lane);
      reduce_scatter(by, lane);
      if (lane < kSub) {
        redx[warp * kTile + s + lane] = bx[0];
        redy[warp * kTile + s + lane] = by[0];
      }
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int row = q * kThreads + threadIdx.x;
      tix[row] = b == 0 ? ax[q] : tix[row] + ax[q];
      tiy[row] = b == 0 ? ay[q] : tiy[row] + ay[q];
      ax[q] = 0.0f;
      ay[q] = 0.0f;
    }
  }
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    ax[q] = tix[q * kThreads + threadIdx.x];
    ay[q] = tiy[q * kThreads + threadIdx.x];
  }
}

// Where a block's sums go in a row launch's workspace (row tiles
// t0 .. t1 - 1, bodies r0 .. r1 - 1): rows() takes the i-side sums of body
// i over tile k, cols() the j-side sums of body j (in tile tj) over tile
// k.  `own`, (nt - t0, 2, r1 - r0), holds slot [K][c][b] of the launch's
// bodies for K = t0 .. nt - 1 at [K - t0][c][b - r0] (the j-side slots
// K < b's tile and the i-side ones from it on); `beyond`,
// (t1 - t0, 2, n - r1), holds the j-side slots K = t0 .. t1 - 1 of the
// bodies past the launch at [K - t0][c][b - r1].
struct RowSlots {
  float* own;
  float* beyond;
  long long t0, t1;
  int64_t r0, r1, n;
  __device__ __forceinline__ void rows(long long k, int64_t i, float sx,
                                       float sy) const {
    const int64_t m = r1 - r0;
    own[(2 * (k - t0)) * m + (i - r0)] = sx;
    own[(2 * (k - t0) + 1) * m + (i - r0)] = sy;
  }
  __device__ __forceinline__ void cols(long long k, long long tj, int64_t j,
                                       float sx, float sy) const {
    if (tj < t1) {
      rows(k, j, sx, sy);
      return;
    }
    const int64_t m = n - r1;
    beyond[(2 * (k - t0)) * m + (j - r1)] = sx;
    beyond[(2 * (k - t0) + 1) * m + (j - r1)] = sy;
  }
};

// One block's tile pair (ti, tj), tj >= ti, of the row launches: stage J
// in sx .. sr, sweep, and hand the sums to `slots`.  This is
// block_forces_symmetric_kernel's body line for line, with its stores
// through `slots`; that kernel keeps its own copy, so that its build stays
// instruction for instruction the one K1's range runs (with this function
// in its place ptxas allocates its registers differently).
template <typename S>
__device__ __forceinline__ void tile_pair_sums(
    const S* __restrict__ x, const S* __restrict__ y,
    const S* __restrict__ m, const S* __restrict__ r, int64_t n,
    long long ti, long long tj, const bool* __restrict__ biased_flag,
    int biased_default, const RowSlots& slots, float* sx, float* sy,
    float* sm, float* sr, float* redx, float* redy, float* tix,
    float* tiy) {
  const int64_t i0 = ti * kTile, j0 = tj * kTile;
  for (int c = threadIdx.x; c < kTile; c += kThreads) {
    const int64_t j = j0 + c;
    const bool in = j < n;
    sx[c] = in ? nbody::to_compute(x[j]) : 0.0f;
    sy[c] = in ? nbody::to_compute(y[j]) : 0.0f;
    sm[c] = in ? nbody::to_compute(m[j]) : 0.0f;
    sr[c] = in ? nbody::to_compute(r[j]) : 0.0f;
  }
  float xi[kRows], yi[kRows], mi[kRows], ri[kRows];
  float ax[kRows], ay[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int64_t i = i0 + q * kThreads + threadIdx.x;
    const bool in = i < n;
    xi[q] = in ? nbody::to_compute(x[i]) : 0.0f;
    yi[q] = in ? nbody::to_compute(y[i]) : 0.0f;
    mi[q] = in ? nbody::to_compute(m[i]) : 0.0f;
    ri[q] = in ? nbody::to_compute(r[i]) : 0.0f;
    ax[q] = 0.0f;
    ay[q] = 0.0f;
  }
  const bool biased = biased_flag != nullptr ? *biased_flag
                                             : biased_default != 0;
  __syncthreads();

  if (ti == tj) {
    // K1's sweep of each row over the tile's 128-column blocks, in order;
    // row q * kThreads + t sits at its place in a 128-row block of the tile,
    // the same block for every thread of a warp.
#pragma unroll 1
    for (int p = 0; p < kRows * kBlocksPerTile; ++p) {
      const int q = p / kBlocksPerTile, cb = p % kBlocksPerTile;
      const int row = q * kThreads + threadIdx.x;
      float px = 0.0f, py = 0.0f;
      nbody::sweep_segment<float>(
          sx + cb * kBlock, sy + cb * kBlock, sm + cb * kBlock,
          sr + cb * kBlock, pick(xi, q), pick(yi, q), pick(ri, q), biased,
          static_cast<long long>(row / kBlock) * kBlock,
          static_cast<long long>(cb) * kBlock, row % kBlock, px, py);
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        if (q == k) {
          ax[k] += px;
          ay[k] += py;
        }
      }
    }
  } else if (biased) {
    sweep_pairs<true>(sx, sy, sm, sr, xi, yi, mi, ri, ax, ay, tix, tiy, redx,
                      redy);
  } else {
    sweep_pairs<false>(sx, sy, sm, sr, xi, yi, mi, ri, ax, ay, tix, tiy, redx,
                       redy);
  }

#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int64_t i = i0 + q * kThreads + threadIdx.x;
    if (i < n) slots.rows(tj, i, ax[q], ay[q]);
  }
  if (ti == tj) return;
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int c = q * kThreads + threadIdx.x;
    float jx = redx[c], jy = redy[c];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      jx += redx[w * kTile + c];
      jy += redy[w * kTile + c];
    }
    const int64_t j = j0 + c;
    if (j < n) slots.cols(ti, tj, j, jx, jy);
  }
}

template <typename S>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
block_forces_symmetric_kernel(
    const S* __restrict__ x, const S* __restrict__ y,
    const S* __restrict__ m, const S* __restrict__ r, int64_t n,
    const bool* __restrict__ biased_flag, int biased_default,
    float* __restrict__ ws) {
  __shared__ float sx[kTile], sy[kTile], sm[kTile], sr[kTile];
  __shared__ float redx[kWarps * kTile], redy[kWarps * kTile];
  __shared__ float tix[kTile], tiy[kTile];

  long long ti, tj;
  tile_pair(blockIdx.x, ti, tj);
  const int64_t i0 = ti * kTile, j0 = tj * kTile;
  for (int c = threadIdx.x; c < kTile; c += kThreads) {
    const int64_t j = j0 + c;
    const bool in = j < n;
    sx[c] = in ? nbody::to_compute(x[j]) : 0.0f;
    sy[c] = in ? nbody::to_compute(y[j]) : 0.0f;
    sm[c] = in ? nbody::to_compute(m[j]) : 0.0f;
    sr[c] = in ? nbody::to_compute(r[j]) : 0.0f;
  }
  float xi[kRows], yi[kRows], mi[kRows], ri[kRows];
  float ax[kRows], ay[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int64_t i = i0 + q * kThreads + threadIdx.x;
    const bool in = i < n;
    xi[q] = in ? nbody::to_compute(x[i]) : 0.0f;
    yi[q] = in ? nbody::to_compute(y[i]) : 0.0f;
    mi[q] = in ? nbody::to_compute(m[i]) : 0.0f;
    ri[q] = in ? nbody::to_compute(r[i]) : 0.0f;
    ax[q] = 0.0f;
    ay[q] = 0.0f;
  }
  const bool biased = biased_flag != nullptr ? *biased_flag
                                             : biased_default != 0;
  __syncthreads();

  if (ti == tj) {
    // K1's sweep of each row over the tile's 128-column blocks, in order;
    // row q * kThreads + t sits at its place in a 128-row block of the tile,
    // the same block for every thread of a warp.
#pragma unroll 1
    for (int p = 0; p < kRows * kBlocksPerTile; ++p) {
      const int q = p / kBlocksPerTile, cb = p % kBlocksPerTile;
      const int row = q * kThreads + threadIdx.x;
      float px = 0.0f, py = 0.0f;
      nbody::sweep_segment<float>(
          sx + cb * kBlock, sy + cb * kBlock, sm + cb * kBlock,
          sr + cb * kBlock, pick(xi, q), pick(yi, q), pick(ri, q), biased,
          static_cast<long long>(row / kBlock) * kBlock,
          static_cast<long long>(cb) * kBlock, row % kBlock, px, py);
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        if (q == k) {
          ax[k] += px;
          ay[k] += py;
        }
      }
    }
  } else if (biased) {
    sweep_pairs<true>(sx, sy, sm, sr, xi, yi, mi, ri, ax, ay, tix, tiy, redx,
                      redy);
  } else {
    sweep_pairs<false>(sx, sy, sm, sr, xi, yi, mi, ri, ax, ay, tix, tiy, redx,
                       redy);
  }

#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int64_t i = i0 + q * kThreads + threadIdx.x;
    if (i < n) {
      ws[(2 * tj) * n + i] = ax[q];
      ws[(2 * tj + 1) * n + i] = ay[q];
    }
  }
  if (ti == tj) return;
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int c = q * kThreads + threadIdx.x;
    float jx = redx[c], jy = redy[c];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      jx += redx[w * kTile + c];
      jy += redy[w * kTile + c];
    }
    const int64_t j = j0 + c;
    if (j < n) {
      ws[(2 * ti) * n + j] = jx;
      ws[(2 * ti + 1) * n + j] = jy;
    }
  }
}

// Block b of a row launch's grid -> its tile pair: the triangle of the
// launch's own tiles first, in the whole grid's order (b = tj (tj + 1) / 2
// + ti counted from t0), then the rectangle of column tiles past t1, row
// tile fastest.
__device__ __forceinline__ void row_tile_pair(long long b, long long t0,
                                              long long rows, long long& ti,
                                              long long& tj) {
  const long long tri = rows * (rows + 1) / 2;
  if (b < tri) {
    tile_pair(b, ti, tj);
    ti += t0;
    tj += t0;
  } else {
    b -= tri;
    tj = t0 + rows + b / rows;
    ti = t0 + b % rows;
  }
}

template <typename S>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
symmetric_rows_kernel(
    const S* __restrict__ x, const S* __restrict__ y,
    const S* __restrict__ m, const S* __restrict__ r, int64_t n,
    long long t0, long long t1, const bool* __restrict__ biased_flag,
    int biased_default, float* __restrict__ own,
    float* __restrict__ beyond) {
  __shared__ float sx[kTile], sy[kTile], sm[kTile], sr[kTile];
  __shared__ float redx[kWarps * kTile], redy[kWarps * kTile];
  __shared__ float tix[kTile], tiy[kTile];

  long long ti, tj;
  row_tile_pair(blockIdx.x, t0, t1 - t0, ti, tj);
  const int64_t r1 = t1 * kTile < n ? t1 * kTile : n;
  tile_pair_sums<S>(x, y, m, r, n, ti, tj, biased_flag, biased_default,
                    RowSlots{own, beyond, t0, t1, t0 * kTile, r1, n}, sx, sy,
                    sm, sr, redx, redy, tix, tiy);
}

// A row launch's fold, one thread a body from r0 on, each sum a plain fp32
// chain in tile order from 0.0, as band_fold_kernel adds the one-launch
// workspace: the launch's bodies add their `own` slots to what earlier
// launches left in `acc` (nothing when t0 == 0), multiply by G * m_i and
// store the result; the bodies past the launch add their `beyond` slots and
// keep the sum in `acc`, (2, n) fp32, for the launches after.
template <typename S>
__global__ void __launch_bounds__(kFoldThreads) symmetric_fold_kernel(
    const float* __restrict__ own, const float* __restrict__ beyond,
    int64_t n, long long t0, long long t1, float* __restrict__ acc,
    const S* __restrict__ m, float gravity, S* __restrict__ xf,
    S* __restrict__ yf) {
  const long long nt = (n + kTile - 1) / kTile;
  const int64_t r0 = t0 * kTile, r1 = t1 * kTile < n ? t1 * kTile : n;
  const int64_t b =
      r0 + static_cast<int64_t>(blockIdx.x) * kFoldThreads + threadIdx.x;
  if (b >= n) return;
  float ax = t0 == 0 ? 0.0f : acc[b];
  float ay = t0 == 0 ? 0.0f : acc[n + b];
  if (b < r1) {
    const int64_t w = r1 - r0;
    for (long long k = 0; k < nt - t0; ++k) {
      ax += own[(2 * k) * w + (b - r0)];
      ay += own[(2 * k + 1) * w + (b - r0)];
    }
    const float gmi = nbody::to_compute(m[b]) * gravity;
    nbody::store(xf + b, ax * gmi);
    nbody::store(yf + b, ay * gmi);
    return;
  }
  const int64_t w = n - r1;
  for (long long k = 0; k < t1 - t0; ++k) {
    ax += beyond[(2 * k) * w + (b - r1)];
    ay += beyond[(2 * k + 1) * w + (b - r1)];
  }
  acc[b] = ax;
  acc[n + b] = ay;
}

template <typename S>
int launch(const S* x, const S* y, const S* m, const S* r, int64_t n,
           int64_t tile, const bool* biased_flag, int biased_default,
           float* ws, void* stream) {
  if (tile != kTile || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t nt = (n + kTile - 1) / kTile;
  const int64_t blocks = nt * (nt + 1) / 2;
  block_forces_symmetric_kernel<S>
      <<<static_cast<unsigned>(blocks), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(x, y, m, r, n, biased_flag,
                                              biased_default, ws);
  return static_cast<int>(cudaGetLastError());
}

// The tiles nt of n bodies, and whether (tile, t0, t1) is a row launch of
// them: tile is kTile, n > 0 and 0 <= t0 < t1 <= nt.
bool row_launch(int64_t n, int64_t tile, int64_t t0, int64_t t1,
                int64_t& nt) {
  nt = (n + kTile - 1) / kTile;
  return tile == kTile && n > 0 && 0 <= t0 && t0 < t1 && t1 <= nt;
}

template <typename S>
int launch_rows(const S* x, const S* y, const S* m, const S* r, int64_t n,
                int64_t tile, int64_t t0, int64_t t1,
                const bool* biased_flag, int biased_default, float* own,
                float* beyond, void* stream) {
  int64_t nt;
  if (!row_launch(n, tile, t0, t1, nt)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t rows = t1 - t0;
  const int64_t blocks = rows * (rows + 1) / 2 + rows * (nt - t1);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  symmetric_rows_kernel<S>
      <<<static_cast<unsigned>(blocks), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(x, y, m, r, n, t0, t1,
                                              biased_flag, biased_default,
                                              own, beyond);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch_fold(const float* own, const float* beyond, int64_t n,
                int64_t tile, int64_t t0, int64_t t1, float* acc,
                const S* m, double gravity, S* xf, S* yf, void* stream) {
  int64_t nt;
  if (!row_launch(n, tile, t0, t1, nt)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t bodies = n - t0 * kTile;
  symmetric_fold_kernel<S>
      <<<static_cast<unsigned>((bodies + kFoldThreads - 1) / kFoldThreads),
         kFoldThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          own, beyond, n, t0, t1, acc, m, static_cast<float>(gravity), xf,
          yf);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 on success), or
// cudaErrorInvalidValue without launching when `tile` is not this build's
// kTile (the caller sizes the workspaces from it) or n is not positive.
// Pointers are device pointers; biased_flag may be null, and then
// biased_default decides.

// The one-launch pass into the (nt, 2, n) fp32 workspace `ws`; fold it with
// nbody_band_fold_*.
int nbody_block_forces_symmetric_f32(const float* x, const float* y,
                                     const float* m, const float* r,
                                     int64_t n, int64_t tile,
                                     const bool* biased_flag,
                                     int biased_default, float* ws,
                                     void* stream) {
  return launch<float>(x, y, m, r, n, tile, biased_flag, biased_default, ws,
                       stream);
}

int nbody_block_forces_symmetric_bf16(
    const __nv_bfloat16* x, const __nv_bfloat16* y, const __nv_bfloat16* m,
    const __nv_bfloat16* r, int64_t n, int64_t tile, const bool* biased_flag,
    int biased_default, float* ws, void* stream) {
  return launch<__nv_bfloat16>(x, y, m, r, n, tile, biased_flag,
                               biased_default, ws, stream);
}

// One row launch, row tiles t0 .. t1 - 1 (0 <= t0 < t1 <= nt), into the
// fp32 workspaces `own`, (nt - t0, 2, r1 - r0), and `beyond`,
// (t1 - t0, 2, n - r1), with r0 = t0 * tile and r1 = min(n, t1 * tile).
int nbody_symmetric_rows_f32(const float* x, const float* y, const float* m,
                             const float* r, int64_t n, int64_t tile,
                             int64_t t0, int64_t t1, const bool* biased_flag,
                             int biased_default, float* own, float* beyond,
                             void* stream) {
  return launch_rows<float>(x, y, m, r, n, tile, t0, t1, biased_flag,
                            biased_default, own, beyond, stream);
}

int nbody_symmetric_rows_bf16(const __nv_bfloat16* x, const __nv_bfloat16* y,
                              const __nv_bfloat16* m, const __nv_bfloat16* r,
                              int64_t n, int64_t tile, int64_t t0, int64_t t1,
                              const bool* biased_flag, int biased_default,
                              float* own, float* beyond, void* stream) {
  return launch_rows<__nv_bfloat16>(x, y, m, r, n, tile, t0, t1, biased_flag,
                                    biased_default, own, beyond, stream);
}

// That launch's fold: the forces of bodies r0 .. r1 - 1 into (xf, yf), the
// running sums of the bodies past r1 into `acc`, (2, n) fp32 (read from the
// second launch on; unused, and may be null, when t1 == nt and t0 == 0).
int nbody_symmetric_fold_f32(const float* own, const float* beyond,
                             int64_t n, int64_t tile, int64_t t0, int64_t t1,
                             float* acc, const float* m, double gravity,
                             float* xf, float* yf, void* stream) {
  return launch_fold<float>(own, beyond, n, tile, t0, t1, acc, m, gravity,
                            xf, yf, stream);
}

int nbody_symmetric_fold_bf16(const float* own, const float* beyond,
                              int64_t n, int64_t tile, int64_t t0, int64_t t1,
                              float* acc, const __nv_bfloat16* m,
                              double gravity, __nv_bfloat16* xf,
                              __nv_bfloat16* yf, void* stream) {
  return launch_fold<__nv_bfloat16>(own, beyond, n, tile, t0, t1, acc, m,
                                    gravity, xf, yf, stream);
}

}  // extern "C"
