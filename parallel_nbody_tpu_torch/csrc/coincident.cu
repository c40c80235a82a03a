// The coincidence flag for Hopper (sm_90a): whether two distinct massive
// bodies share a position exactly, as one 0-d bool on the device that the
// force kernels read (ops/cuda_step.py::forces_coincident_dispatch).
//
// Replaces no Pallas kernel.  The JAX package's any_coincident is XLA's
// lax.sort on (x, y, mass) (parallel_nbody_tpu/ops/pallas_step.py:535), and
// the port ran the same through three stable torch.sort passes
// (ops/cuda_step.py::any_coincident_reference, this kernel's plain version):
// about 60 device operations to answer one yes/no question.
//
// What it computes.  A body takes part if its x and y are not NaN and its
// mass is > 0 or NaN; the flag is set iff two bodies that take part sit at
// one position and at least one of them has mass > 0.  That is the sort's
// answer on every state: the sort groups equal positions (NaN positions
// equal nothing), orders each group by mass with NaN masses last, and fires
// where a group's member other than its last has mass > 0.  So zero-mass
// padding, which sits at one far coordinate, can neither fake a pair nor
// hide one.  Positions are normalised as the plain version does (x + 0, so
// that -0 and +0 hash alike); bfloat16 positions are compared as their
// exact float32 values.
//
// How.  An open-addressing hash table of `slots` int32 entries, a power of
// two at least 2n (the wrapper gives 4n, so at most a quarter full), each 0
// (empty) or a body's index + 1.  One thread per body hashes the bits of
// its normalised (x, y) with murmur3's 64-bit finaliser (full avalanche:
// the glibc bodies sit on whole pixels, whose bits differ in a few high
// places, and a weak hash would chain) and probes linearly: it claims an
// empty slot with atomicCAS, or meets the body that holds the slot.  A holder at an equal position (==
// as values) ends the probe, and sets the flag if either mass is > 0; any
// other holder sends the probe on.  Slots are written once and never
// emptied, so two bodies at one position probe the same slots in the same
// order and the later one always meets the earlier one or a body at the
// same position: no pair is missed, whatever order the atomics take, and
// the answer is deterministic.  A body needs one slot at most, so the table
// never fills.  A thread that finds the flag already set skips its probe,
// which saves work and decides nothing.
//
// Bound: memory.  The work is to read x, y and mass once (12 bytes a body
// in fp32): 786 KB at N=65536, under 1 us at 3.35 TB/s.  The design keeps
// to that: one launch, coalesced reads of the three arrays, and a table of
// 4 bytes a slot (1 MiB at 65536, 16 MiB at 1048576) that stays in the
// 50 MB L2 with the holders' positions it reads back; no sort, no second
// pass.  What it costs above that is latency: a kernel lasts as long as
// its longest probe, one L2 round trip a slot, and at a quarter full the
// longest of 65536 probes passes ~14 slots (~28 at half full, measured on
// the H100).  So each probe goes straight to atomicCAS, whose answer is
// the slot's holder, with no read before it.  The launcher clears the
// table and the flag, which the wrapper lays out as one buffer, with one
// cudaMemsetAsync: two device operations a call, and no counter carried
// from call to call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load(const float* p, int64_t i) {
  return p[i];
}
__device__ __forceinline__ float load(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ double load(const double* p, int64_t i) {
  return p[i];
}

// x + 0 maps -0 to +0 and leaves every other value as it is.
__device__ __forceinline__ float plus_zero(float v) {
  return __fadd_rn(v, 0.0f);
}
__device__ __forceinline__ double plus_zero(double v) {
  return __dadd_rn(v, 0.0);
}

// murmur3's 64-bit finaliser.
__device__ __forceinline__ uint64_t fmix64(uint64_t k) {
  k ^= k >> 33;
  k *= 0xff51afd7ed558ccdULL;
  k ^= k >> 33;
  k *= 0xc4ceb9fe1a85ec53ULL;
  k ^= k >> 33;
  return k;
}

// Hashes of a normalised position: equal values have equal bits.
__device__ __forceinline__ uint64_t hash(float x, float y) {
  return fmix64((static_cast<uint64_t>(__float_as_uint(x)) << 32) |
                __float_as_uint(y));
}
__device__ __forceinline__ uint64_t hash(double x, double y) {
  return fmix64(static_cast<uint64_t>(__double_as_longlong(x)) ^
                fmix64(static_cast<uint64_t>(__double_as_longlong(y))));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    coincident_kernel(const T* __restrict__ x, const T* __restrict__ y,
                      const T* __restrict__ m, int64_t n, int* table,
                      uint64_t mask, bool* flag) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const auto xi = plus_zero(load(x, i));
  const auto yi = plus_zero(load(y, i));
  const auto mi = load(m, i);
  if (isnan(xi) || isnan(yi) || !(mi > 0 || isnan(mi))) return;
  const volatile bool* const set = flag;
  if (*set) return;
  const int me = static_cast<int>(i) + 1;
  for (uint64_t s = hash(xi, yi) & mask;; s = (s + 1) & mask) {
    const int held = atomicCAS(table + s, 0, me);
    if (held == 0) return;
    const int64_t h = held - 1;
    // == holds -0 and +0 equal, so the holder's values need no + 0.
    if (load(x, h) == xi && load(y, h) == yi) {
      // Stored only where still unset: on states with many coincident
      // bodies, stores from every one of them would queue at one address.
      if ((mi > 0 || load(m, h) > 0) && !*set) *flag = true;
      return;
    }
  }
}

template <typename T>
int launch(const T* x, const T* y, const T* m, int64_t n, int* table,
           int64_t slots, bool* flag, void* stream) {
  // The wrapper lays the flag out right after the table, so one memset
  // clears both; a table that could fill, or n past the int32 indices,
  // is refused.
  if (n < 0 || n >= INT32_MAX || slots < 2 || (slots & (slots - 1)) != 0 ||
      slots < 2 * n ||
      reinterpret_cast<char*>(flag) !=
          reinterpret_cast<char*>(table + slots)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      cudaMemsetAsync(table, 0, slots * sizeof(int) + 1, s);
  if (err != cudaSuccess || n < 2) return static_cast<int>(err);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  coincident_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      x, y, m, n, table, static_cast<uint64_t>(slots - 1), flag);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 on success).  Pointers are
// device pointers: x, y and mass hold n values each, table `slots` int32
// entries followed directly by the 0-d bool flag.
int nbody_any_coincident_f32(const float* x, const float* y, const float* m,
                             int64_t n, int* table, int64_t slots,
                             bool* flag, void* stream) {
  return launch<float>(x, y, m, n, table, slots, flag, stream);
}

int nbody_any_coincident_f64(const double* x, const double* y,
                             const double* m, int64_t n, int* table,
                             int64_t slots, bool* flag, void* stream) {
  return launch<double>(x, y, m, n, table, slots, flag, stream);
}

int nbody_any_coincident_bf16(const __nv_bfloat16* x, const __nv_bfloat16* y,
                              const __nv_bfloat16* m, int64_t n, int* table,
                              int64_t slots, bool* flag, void* stream) {
  return launch<__nv_bfloat16>(x, y, m, n, table, slots, flag, stream);
}

}  // extern "C"
