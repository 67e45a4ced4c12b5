// Planes of Philox uniforms, for Hopper (sm_90a).
//
// One kernel with a plain C interface (loaded with ctypes by
// repro_torch.kernels.draws):
//
// * philox_fill: float32 uniforms of Philox4x32-10 at counter
//   (offset, c1, index, c3), key (k0, k1) a member, written lane by
//   lane: lane l of member b's element i lands at
//   out[l * lane_stride + b * count + i] (lane_stride is members * count
//   where a launch takes every member of the buffer).  The index of
//   element i is i itself (a row-major (n, h) plane, index = row * h +
//   col) or entry i of an int32 index plane shared by the members (the
//   3D model's flat global index, a shard's global positions).  A
//   uniform is the draw rounded to the nearest float32, times 2^-32, as
//   repro_torch.core.rng.u32_to_uniform computes it.
//
//   It replaces no TPU kernel.  The JAX package computes these draws in
//   jnp (repro/core/rng.py: uniforms), and XLA fuses them into the
//   update of the engines whose update is plain jnp (basic, basic_philox,
//   spinglass, wolff, the 3D model).  The port keeps those updates plain
//   PyTorch, whose Philox on 16-bit limbs costs hundreds of times what a
//   kernel does on the card, so their draws come from here.
//
//   Bound: the Philox rounds.  A lane-0 draw costs 16 wide multiplies
//   and 17 XORs once the offset's work is hoisted (the compiler hoists
//   it: offset, lanes and keys are the same for every element of a
//   member), against 4 bytes written; two lanes (the couplings') cost
//   the same rounds against 8 bytes (no caller draws more than two
//   lanes, so no more are compiled).  So a thread takes one element at a
//   time and walks the plane in a grid-stride loop; its stores are
//   coalesced, one float a thread a lane.  No shared memory.
#include "common.cuh"
#include "philox.cuh"

namespace {

using repro_torch::Members;

constexpr int kThreads = 256;
// Blocks a member, at most: 32 waves of a block per SM on 132 SMs; the
// grid-stride loop takes the rest of the plane
constexpr long long kMaxBlocks = 132 * 32;

struct Key {
  uint32_t k0, k1;
};

__device__ __forceinline__ float to_uniform(uint32_t bits) {
  return __uint2float_rn(bits) * 2.3283064365386963e-10f;
}

template <int kLanes, bool kIndexed, bool kBatch>
__global__ void __launch_bounds__(kThreads) philox_fill_kernel(
    float* __restrict__ out, const int32_t* __restrict__ index,
    long long count, long long lane_stride, uint32_t offset, uint32_t c1,
    uint32_t c3, const __grid_constant__ Members<Key, kBatch> keys) {
  const int member = repro_torch::member_index<kBatch>();
  const Key key = keys.v[member];
  float* dst = out + static_cast<long long>(member) * count;
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < count; i += step) {
    const uint32_t site = kIndexed ? static_cast<uint32_t>(__ldg(index + i))
                                   : static_cast<uint32_t>(i);
    const uint4 r = repro_torch::philox4x32_10(make_uint4(offset, c1, site, c3),
                                               key.k0, key.k1);
    dst[i] = to_uniform(r.x);
    if (kLanes > 1) dst[lane_stride + i] = to_uniform(r.y);
  }
}

template <int kLanes, bool kBatch>
int launch(float* out, const int32_t* index, long long count,
           long long lane_stride, int members, const uint32_t* k,
           uint32_t offset, uint32_t c1, uint32_t c3, cudaStream_t s) {
  Members<Key, kBatch> keys;
  for (int i = 0; i < members; ++i) keys.v[i] = Key{k[2 * i], k[2 * i + 1]};
  long long blocks = (count + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const dim3 grid(static_cast<unsigned>(blocks), 1, members);
  if (index != nullptr) {
    philox_fill_kernel<kLanes, true, kBatch><<<grid, kThreads, 0, s>>>(
        out, index, count, lane_stride, offset, c1, c3, keys);
  } else {
    philox_fill_kernel<kLanes, false, kBatch><<<grid, kThreads, 0, s>>>(
        out, index, count, lane_stride, offset, c1, c3, keys);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kBatch>
int launch_lanes(int lanes, float* out, const int32_t* index, long long count,
                 long long lane_stride, int members, const uint32_t* k,
                 uint32_t offset, uint32_t c1, uint32_t c3, cudaStream_t s) {
  switch (lanes) {
    case 1:
      return launch<1, kBatch>(out, index, count, lane_stride, members, k,
                               offset, c1, c3, s);
    case 2:
      return launch<2, kBatch>(out, index, count, lane_stride, members, k,
                               offset, c1, c3, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// The most members one batched launch of this library takes.
int draws_max_members() { return repro_torch::max_members<Key>(); }

// out: the first member's lane 0 in a float32 buffer whose lane l starts
// lane_stride elements after lane l - 1, members count elements apart;
// index: count int32 site indices shared by the members, or null for
// index = element; keys: the members' (k0, k1) pairs
int philox_fill_launch(void* out, const void* index, long long count,
                       long long lane_stride, int lanes, int members,
                       const uint32_t* keys, uint32_t offset, uint32_t c1,
                       uint32_t c3, void* stream) {
  if (count < 1 || repro_torch::check_members<Key>(members)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* o = static_cast<float*>(out);
  const int32_t* idx = static_cast<const int32_t*>(index);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return members > 1 ? launch_lanes<true>(lanes, o, idx, count, lane_stride,
                                          members, keys, offset, c1, c3, s)
                     : launch_lanes<false>(lanes, o, idx, count, lane_stride,
                                           1, keys, offset, c1, c3, s);
}

}  // extern "C"
