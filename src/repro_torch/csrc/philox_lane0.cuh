// Lane 0 of Philox4x32-10 at counter (offset, 0, site, 0), for kernels
// that draw once per site with one offset and one key for a whole
// half-sweep (stencil.cu's k-sweep and shard kernels).
//
// The same bits as philox4x32_10(make_uint4(offset, 0, site, 0), k0,
// k1).x (philox.cuh).  What depends only on the offset and the key is
// computed once per half-sweep, in the constructor: the key schedule,
// round 0's product of the offset, round 1's product of the third lane
// (which round 0 leaves the same for every site) and the XOR constants
// they give.  Per site that leaves 17 32x32 products, each one wide
// multiply (IMAD.WIDE.U32, round 9's high half alone IMAD.HI), and 18
// XORs, most of them three-input: one product in rounds 0 and 1, two in
// rounds 2 to 8, and in round 9 only lane x.
#pragma once

#include <cstdint>

#include "philox.cuh"

namespace repro_torch {

// hi:lo = a * b, one wide multiply
__device__ __forceinline__ void mul_wide(uint32_t a, uint32_t b,
                                         uint32_t& hi, uint32_t& lo) {
  const uint64_t p = static_cast<uint64_t>(a) * b;
  hi = static_cast<uint32_t>(p >> 32);
  lo = static_cast<uint32_t>(p);
}

class Lane0Philox {
 public:
  __device__ __forceinline__ Lane0Philox(uint32_t offset, uint32_t key0,
                                         uint32_t key1) {
#pragma unroll
    for (int r = 0; r < 10; ++r) {
      k0_[r] = key0 + static_cast<uint32_t>(r) * kPhiloxW0;
      k1_[r] = key1 + static_cast<uint32_t>(r) * kPhiloxW1;
    }
    // round 0, lanes x = offset and w = 0: z1 = hi(M0 offset) ^ k1,
    // w1 = lo(M0 offset)
    uint32_t hi, lo;
    mul_wide(kPhiloxM0, offset, hi, lo);
    const uint32_t z1 = hi ^ k1_[0];
    const uint32_t w1 = lo;
    // round 1, lane z1: x2 = y1 ^ hi(M1 z1) ^ k0, y2 = lo(M1 z1),
    // z2 = hi(M0 x1) ^ w1 ^ k1
    mul_wide(kPhiloxM1, z1, hi, lo);
    x2_xor_ = hi ^ k0_[1];
    z2_xor_ = w1 ^ k1_[1];
    // round 2: x3 = hi(M1 z2) ^ y2 ^ k0
    x3_xor_ = lo ^ k0_[2];
  }

  __device__ __forceinline__ uint32_t operator()(uint32_t site) const {
    uint32_t hi0, lo0, hi1, lo1;
    // round 0: lanes y and w are 0
    mul_wide(kPhiloxM1, site, hi1, lo1);
    const uint32_t x1 = hi1 ^ k0_[0];
    const uint32_t y1 = lo1;
    // round 1
    mul_wide(kPhiloxM0, x1, hi0, lo0);
    uint32_t x = y1 ^ x2_xor_;
    uint32_t z = hi0 ^ z2_xor_;
    uint32_t w = lo0;
    // round 2: lane y2 is the same for every site
    mul_wide(kPhiloxM0, x, hi0, lo0);
    mul_wide(kPhiloxM1, z, hi1, lo1);
    x = hi1 ^ x3_xor_;
    uint32_t y = lo1;
    z = hi0 ^ w ^ k1_[2];
    w = lo0;
#pragma unroll
    for (int r = 3; r < 9; ++r) {
      mul_wide(kPhiloxM0, x, hi0, lo0);
      mul_wide(kPhiloxM1, z, hi1, lo1);
      x = hi1 ^ y ^ k0_[r];
      y = lo1;
      z = hi0 ^ w ^ k1_[r];
      w = lo0;
    }
    // round 9: lane x alone
    return __umulhi(kPhiloxM1, z) ^ y ^ k0_[9];
  }

 private:
  uint32_t k0_[10];
  uint32_t k1_[10];
  uint32_t x2_xor_;
  uint32_t z2_xor_;
  uint32_t x3_xor_;
};

}  // namespace repro_torch
