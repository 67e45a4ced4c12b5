// Philox4x32-10 at counter (offset, 0, site, 0) with the offset's work
// hoisted, for kernels that draw with one offset and one key for a whole
// half-sweep: lane 0 (stencil.cu's kernels), lanes 0 and 1
// (tensorcore.cu: one per target plane) or all four lanes (the bitplane
// k-sweep and shard kernels: one per word of a 4-word group).
//
// The same bits as philox4x32_10(make_uint4(offset, 0, site, 0), k0,
// k1) (philox.cuh).  What depends only on the offset and the key is
// computed once, in the constructor: the key schedule, round 0's product
// of the offset, round 1's product of the third lane (which round 0
// leaves the same for every site) and the XOR constants they give.  Per
// site that leaves one product in rounds 0 and 1 and two in each of
// rounds 2 to 8, and about 17 XORs, most of them three-input.  Every
// product of rounds 0 to 7 is a wide multiply (both halves,
// IMAD.WIDE.U32).  Round 8's two products feed round 9's lanes: for
// lane 0, and for lanes 0 and 1, only the high half of M0 x (IMAD.HI) and
// the low half of M1 z (one 32-bit IMAD), since round 9's lanes z and w
// and its product of x are not needed; round 9 then takes the high half
// of M1 z for lane 0, both halves of it for lanes 0 and 1 (lane y is the
// low half of the product whose high half makes lane x).  So lane 0 and
// lanes 0 and 1 each take 16 wide multiplies (IMAD.WIDE.U32 or IMAD.HI,
// which issue at one rate) and one low half a site, 17 products.  All
// four lanes need both halves of round 8's products and a second wide
// multiply in round 9: 18 wide multiplies.
//
// HoistedPhiloxPair draws the two calls of a multispin word, at counters
// (c, 0, site, 0) and (c + 1, 0, site, 0), all four lanes of each.  The
// counters differ in lane x only, which round 0 multiplies by itself:
// round 0's product of the site and round 1's product of lane x
// (hi(M1 site) ^ k0) are the same for both calls and made once.  That
// leaves 2 + 2 x 16 = 34 wide multiplies and 1 + 2 x 18 = 37 XORs a
// site.  Its key schedule (PhiloxKeys) is made on the host and passed to
// the kernel by value, so that the rounds take the keys as constant-bank
// operands and no registers.
#pragma once

#include <cstdint>

#include "philox.cuh"

namespace repro_torch {

// hi:lo = a * b, one wide multiply
__host__ __device__ __forceinline__ void mul_wide(uint32_t a, uint32_t b,
                                                  uint32_t& hi,
                                                  uint32_t& lo) {
  const uint64_t p = static_cast<uint64_t>(a) * b;
  hi = static_cast<uint32_t>(p >> 32);
  lo = static_cast<uint32_t>(p);
}

// The key schedule of rounds 0 to 9: key + r W.
struct PhiloxKeys {
  uint32_t k0[10];
  uint32_t k1[10];

  PhiloxKeys() = default;

  __host__ __device__ __forceinline__ PhiloxKeys(uint32_t key0,
                                                 uint32_t key1) {
#pragma unroll
    for (int r = 0; r < 10; ++r) {
      k0[r] = key0 + static_cast<uint32_t>(r) * kPhiloxW0;
      k1[r] = key1 + static_cast<uint32_t>(r) * kPhiloxW1;
    }
  }
};

// The constructor also runs on the host: a kernel that draws with one
// offset a launch takes the object as a kernel parameter, so that its
// constants are operands in the constant bank and take no registers.  A
// kernel that draws with one offset a half-sweep makes it from the key
// schedule it takes as a parameter, which so stays in the constant bank.
class HoistedPhilox {
 public:
  HoistedPhilox() = default;

  __host__ __device__ __forceinline__ HoistedPhilox(uint32_t offset,
                                                    uint32_t key0,
                                                    uint32_t key1)
      : HoistedPhilox(offset, PhiloxKeys(key0, key1)) {}

  __host__ __device__ __forceinline__ HoistedPhilox(uint32_t offset,
                                                    const PhiloxKeys& keys)
      : keys_(keys) {
    // round 0, lanes x = offset and w = 0: z1 = hi(M0 offset) ^ k1,
    // w1 = lo(M0 offset)
    uint32_t hi, lo;
    mul_wide(kPhiloxM0, offset, hi, lo);
    const uint32_t z1 = hi ^ keys_.k1[0];
    const uint32_t w1 = lo;
    // round 1, lane z1: x2 = y1 ^ hi(M1 z1) ^ k0, y2 = lo(M1 z1),
    // z2 = hi(M0 x1) ^ w1 ^ k1
    mul_wide(kPhiloxM1, z1, hi, lo);
    x2_xor_ = hi ^ keys_.k0[1];
    z2_xor_ = w1 ^ keys_.k1[1];
    // round 2: x3 = hi(M1 z2) ^ y2 ^ k0
    x3_xor_ = lo ^ keys_.k0[2];
  }

  // lane 0
  __device__ __forceinline__ uint32_t operator()(uint32_t site) const {
    uint32_t x, y, z, w;
    rounds(site, x, y, z, w);
    return __umulhi(kPhiloxM1, z) ^ y ^ keys_.k0[9];
  }

  // lanes 0 and 1: round 9's x and y, the two halves of one product
  __device__ __forceinline__ uint2 lanes01(uint32_t site) const {
    uint32_t x, y, z, w, hi, lo;
    rounds(site, x, y, z, w);
    mul_wide(kPhiloxM1, z, hi, lo);
    return make_uint2(hi ^ y ^ keys_.k0[9], lo);
  }

  // all four lanes
  __device__ __forceinline__ uint4 lanes(uint32_t site) const {
    uint32_t x, y, z, w, hi0, lo0, hi1, lo1;
    rounds(site, x, y, z, w);
    mul_wide(kPhiloxM0, x, hi0, lo0);
    mul_wide(kPhiloxM1, z, hi1, lo1);
    return make_uint4(hi1 ^ y ^ keys_.k0[9], lo1, hi0 ^ w ^ keys_.k1[9],
                      lo0);
  }

 private:
  // the state (x, y, z, w) after rounds 0 to 8
  __device__ __forceinline__ void rounds(uint32_t site, uint32_t& x,
                                         uint32_t& y, uint32_t& z,
                                         uint32_t& w) const {
    uint32_t hi0, lo0, hi1, lo1;
    // round 0: lanes y and w are 0
    mul_wide(kPhiloxM1, site, hi1, lo1);
    const uint32_t x1 = hi1 ^ keys_.k0[0];
    const uint32_t y1 = lo1;
    // round 1
    mul_wide(kPhiloxM0, x1, hi0, lo0);
    x = y1 ^ x2_xor_;
    z = hi0 ^ z2_xor_;
    w = lo0;
    // round 2: lane y2 is the same for every site
    mul_wide(kPhiloxM0, x, hi0, lo0);
    mul_wide(kPhiloxM1, z, hi1, lo1);
    x = hi1 ^ x3_xor_;
    y = lo1;
    z = hi0 ^ w ^ keys_.k1[2];
    w = lo0;
#pragma unroll
    for (int r = 3; r < 9; ++r) {
      mul_wide(kPhiloxM0, x, hi0, lo0);
      mul_wide(kPhiloxM1, z, hi1, lo1);
      x = hi1 ^ y ^ keys_.k0[r];
      y = lo1;
      z = hi0 ^ w ^ keys_.k1[r];
      w = lo0;
    }
  }

  PhiloxKeys keys_;
  uint32_t x2_xor_;
  uint32_t z2_xor_;
  uint32_t x3_xor_;
};

class HoistedPhiloxPair {
 public:
  // counter c (even for a multispin word: 2 offset, modulo 2^32); the
  // second call's c + 1 wraps modulo 2^32 as well
  __host__ __device__ __forceinline__ HoistedPhiloxPair(
      uint32_t counter, const PhiloxKeys& keys)
      : keys_(keys) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      // as HoistedPhilox: round 0's product of the counter, round 1's of
      // lane z1, both the same for every site
      uint32_t hi, lo;
      mul_wide(kPhiloxM0, counter + static_cast<uint32_t>(c), hi, lo);
      const uint32_t z1 = hi ^ keys.k1[0];
      z2_xor_[c] = lo ^ keys.k1[1];
      mul_wide(kPhiloxM1, z1, hi, lo);
      x2_xor_[c] = hi ^ keys.k0[1];
      x3_xor_[c] = lo ^ keys.k0[2];
    }
  }

  // the 8 draws of a site: lanes x, y, z, w of the call at c, then of
  // the call at c + 1
  __device__ __forceinline__ void operator()(uint32_t site,
                                             uint32_t (&out)[8]) const {
    uint32_t hi, lo, hi0, lo0;
    // round 0, shared: lanes y and w are 0
    mul_wide(kPhiloxM1, site, hi, lo);
    const uint32_t x1 = hi ^ keys_.k0[0];
    const uint32_t y1 = lo;
    // round 1, shared: the product of lane x1
    mul_wide(kPhiloxM0, x1, hi0, lo0);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      uint32_t x = y1 ^ x2_xor_[c];
      uint32_t z = hi0 ^ z2_xor_[c];
      uint32_t w = lo0;
      uint32_t y, h0, l0, h1, l1;
      // round 2: lane y2 is the same for every site (in x3_xor_)
      mul_wide(kPhiloxM0, x, h0, l0);
      mul_wide(kPhiloxM1, z, h1, l1);
      x = h1 ^ x3_xor_[c];
      y = l1;
      z = h0 ^ w ^ keys_.k1[2];
      w = l0;
#pragma unroll
      for (int r = 3; r < 10; ++r) {
        mul_wide(kPhiloxM0, x, h0, l0);
        mul_wide(kPhiloxM1, z, h1, l1);
        x = h1 ^ y ^ keys_.k0[r];
        y = l1;
        z = h0 ^ w ^ keys_.k1[r];
        w = l0;
      }
      out[4 * c] = x;
      out[4 * c + 1] = y;
      out[4 * c + 2] = z;
      out[4 * c + 3] = w;
    }
  }

 private:
  PhiloxKeys keys_;
  uint32_t x2_xor_[2];
  uint32_t z2_xor_[2];
  uint32_t x3_xor_[2];
};

}  // namespace repro_torch
