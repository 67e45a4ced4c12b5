// Helpers that every kernel library of csrc/ shares: the periodic wrap of
// an index, the halo geometry of the k-sweep and shard tiles of
// stencil.cu and multispin.cu, the uint32 threshold table of the word
// families, the member records of an ensemble launch, and the error
// string of the plain C interface.
//
// Each .cu builds into a shared library of its own and includes this
// header once, so the extern "C" function below is defined once in each
// library.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace repro_torch {

// x modulo size, in [0, size) for negative x too.
__device__ __forceinline__ int wrap(int x, int size) {
  const int r = x % size;
  return r < 0 ? r + size : r;
}

// x modulo size for x a few sizes out of [0, size): no division
__device__ __forceinline__ int wrap_near(int x, int size) {
  while (x < 0) x += size;
  while (x >= size) x -= size;
  return x;
}

// Plane elements (int8 cells, or words) of halo left of a k-sweep tile:
// 2k, rounded up to 4 (a 32-bit word of cells, or 16 bytes of words)
__host__ __device__ inline int left_halo(int n_sweeps) {
  return (2 * n_sweeps + 3) & ~3;
}

// Elements of an extended tile row: the tile and the left halo on each
// side, rounded up to 4 (the right halo is at least the left one)
__host__ __device__ inline int ext_cols(int tile_c, int n_sweeps) {
  return (tile_c + 2 * left_halo(n_sweeps) + 3) & ~3;
}

inline bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Entries of the word families' acceptance table: index s * 5 + c for
// spin s in {0, 1} and neighbour count c in 0..4.
constexpr int kClasses = 10;

// The 10 uint32 thresholds (repro_torch.core.multispin.
// acceptance_thresholds), passed to a kernel by value: flip iff the raw
// uint32 draw is below the entry of the site's class.
struct Thresholds {
  uint32_t v[kClasses];
};

inline Thresholds make_thresholds(const uint32_t* thr) {
  Thresholds t;
  std::memcpy(t.v, thr, sizeof(t.v));
  return t;
}

// -- ensembles: the member as a grid axis ----------------------------------
//
// An ensemble launch updates the planes of B members at once, stacked
// (B, n, w) in device memory, with blockIdx.z the member: each block
// moves its plane pointers by member * n * w elements and reads its
// member's own parameters (draw bounds or thresholds, Philox keys) from
// one record of a __grid_constant__ kernel parameter, indexed by
// blockIdx.z.  Kernel parameters live in the constant bank, so the
// record costs no device-memory load and no shared memory; the start
// offset, the shapes and the tile are shared by all members.  A launch
// of one member takes the kernel's kBatch = false instance, whose one
// record sits at constant offsets, so its loops read the parameters as
// constant-bank operands, as a by-value parameter is read.

// Bytes of kernel parameters a launch may pass: 32764 from CUDA 12.1 on
// (sm_70 and later), else 4096.
#if CUDART_VERSION >= 12010
constexpr size_t kParamBytes = 32764;
#else
constexpr size_t kParamBytes = 4096;
#endif

// Members of one batched launch with records of type Rec: as many as the
// parameter space holds beside a kernel's other arguments (512 bytes at
// the most).  The records of a batched launch fill that space whatever B
// is.  A larger ensemble takes ceil(B / limit) launches a block of sweeps
// (the wrappers split it).
template <class Rec>
constexpr int max_members() {
  return static_cast<int>((kParamBytes - 512) / sizeof(Rec));
}

// The records of a launch: one (kBatch false) or max_members().
template <class Rec, bool kBatch>
struct Members {
  Rec v[kBatch ? max_members<Rec>() : 1];
};

// Elements of the planes of members before `member`.
__device__ __forceinline__ size_t member_offset(int member, int n, int w) {
  return static_cast<size_t>(member) * static_cast<size_t>(n) *
         static_cast<size_t>(w);
}

// The kernel's member: blockIdx.z in a batched instance, else 0 (a
// constant, so the single instance moves no pointer).
template <bool kBatch>
__device__ __forceinline__ int member_index() {
  return kBatch ? static_cast<int>(blockIdx.z) : 0;
}

// Checks of a batched launch's member count; returns the CUDA error.
template <class Rec>
inline int check_members(int members) {
  return members < 1 || members > max_members<Rec>() || members > 65535
             ? static_cast<int>(cudaErrorInvalidValue)
             : 0;
}

}  // namespace repro_torch

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
