// Helpers that every kernel library of csrc/ shares: the periodic wrap of
// an index, the uint32 threshold table of the word families, and the
// error string of the plain C interface.
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
