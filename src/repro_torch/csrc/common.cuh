// Helpers that every kernel library of csrc/ shares: the periodic wrap of
// an index, the halo geometry of the k-sweep and shard tiles of
// stencil.cu and multispin.cu, the uint32 threshold table of the word
// families, and the error string of the plain C interface.
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

}  // namespace repro_torch

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
