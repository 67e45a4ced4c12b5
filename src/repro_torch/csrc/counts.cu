// Per-replica counts of the bitplane observables (32 replicas per uint32
// word, bit r = replica r), for Hopper (sm_90a).
//
// One kernel with a plain C interface (loaded with ctypes by
// repro_torch.kernels.bitplane.counts):
//
// * bitplane_counts: for each member of (B, n, w) black and white word
//   planes and each replica r, two integer counts in one pass: up_r, the
//   set bits of replica r in both planes, and D_r, the bonds whose ends
//   disagree in bit r -- every black word XOR each of its four white
//   neighbours: up, down, centre and the row-parity side tap of
//   lattice.side_shift(..., is_black=True) (odd rows (i, k+1), even rows
//   (i, k-1)), rows and columns periodic.  They land in out[b][0][r] and
//   out[b][1][r] (int64), added by atomics into a zeroed buffer.
//
//   It replaces no TPU kernel.  The JAX package computes a replica's m
//   and e in jnp (src/repro/core/bitplane.py: replica_observables, which
//   unpacks the 32 lattices); the port's plain version
//   (repro_torch.core.bitplane.plane_bit_counts over the planes and four
//   XORed copies of rolled white planes) spreads each word into 32
//   shifted copies.
//
//   Bound: bytes, each word of both planes read once: 8 bytes a pair of a
//   black and a white word, 1.07e9 at 16384^2 x 32, 0.32 ms at 3.35
//   TB/s.  That leaves about 40 integer instructions a pair, where a loop
//   over the 32 bits of each of the 6 counted words costs about 400.
//   What the design does about it:
//   - A warp walks a strip of 128 words (a 16-byte vector a lane) down a
//     run of rows, with the row above in registers: the vertical bonds of
//     row i are b_i ^ w_{i-1} (a black word's up bond) and b_{i-1} ^ w_i
//     (the down bond of the black word above it), so each word is loaded
//     once, and the run's first row above it once more.  The side tap
//     comes from the neighbouring lane by a shuffle; a strip's edge lane
//     loads the one word beyond it.  The next row's loads are issued
//     before the current row is counted.
//   - The counted words go into bit-sliced vertical counters: a
//     Harley-Seal tree of carry-save adders (two LOP3s each) folds a
//     row's 8 words of set bits into an eights word and its 16 bond words
//     into a sixteens word, each added into a ripple counter of kLevels
//     levels (2 operations a level).
//   - Before the ripple counters can overflow (kFlushRows rows), the warp
//     adds its lanes' counters bit-sliced, by a butterfly of 5 shuffles a
//     level, and lane r reads bit r of every level: replica r's count,
//     into a 64-bit register of lane r.
//   - The block sums its warps' counts in shared memory and adds each of
//     its 64 counts to the output with one atomicAdd.
//   The runs' length follows the card: one warp a run of a strip, as many
//   warps as the card holds at once.  Integer sums are exact in any
//   order, so the counts equal the plain version's whatever the launch.

#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kReplicas = 32;
// levels of a ripple counter, and the rows it takes without overflow
// (one word a row)
constexpr int kLevels = 8;
constexpr int kFlushRows = (1 << kLevels) - 1;
// levels of the Harley-Seal trees: ones, twos and fours (set bits, 8
// words a row), and eights (bonds, 16 words a row)
constexpr int kUpTree = 3;
constexpr int kBondTree = 4;
// the fewest rows of a run: the row above each run is read twice
constexpr int kMinRows = 16;
// members a launch takes (gridDim.y)
constexpr int kMaxGridY = 65535;

// a vertical counter: bit r of level j has weight 2^j in replica r's
// count; the tree's levels first, then the ripple counter's
template <int kTree>
struct Counter {
  uint32_t v[kTree + kLevels];
};

// a + b + c = low + 2 high, bit by bit
__device__ __forceinline__ void csa(uint32_t& high, uint32_t& low,
                                    uint32_t a, uint32_t b, uint32_t c) {
  const uint32_t u = a ^ b;
  high = (a & b) | (u & c);
  low = u ^ c;
}

// 8 words of weight 1 into levels 0-2; returns the carry of weight 8
__device__ __forceinline__ uint32_t add8(uint32_t* v, const uint32_t* x) {
  uint32_t two_a, two_b, four_a, four_b, eight;
  csa(two_a, v[0], v[0], x[0], x[1]);
  csa(two_b, v[0], v[0], x[2], x[3]);
  csa(four_a, v[1], v[1], two_a, two_b);
  csa(two_a, v[0], v[0], x[4], x[5]);
  csa(two_b, v[0], v[0], x[6], x[7]);
  csa(four_b, v[1], v[1], two_a, two_b);
  csa(eight, v[2], v[2], four_a, four_b);
  return eight;
}

// 16 words of weight 1 into levels 0-3; returns the carry of weight 16
__device__ __forceinline__ uint32_t add16(uint32_t* v, const uint32_t* x) {
  const uint32_t eight_a = add8(v, x);
  const uint32_t eight_b = add8(v, x + 8);
  uint32_t sixteen;
  csa(sixteen, v[3], v[3], eight_a, eight_b);
  return sixteen;
}

// the tree's carry x (weight 2^kTree) into the ripple counter
template <int kTree>
__device__ __forceinline__ void ripple(Counter<kTree>& c, uint32_t x) {
#pragma unroll
  for (int j = kTree; j < kTree + kLevels; ++j) {
    const uint32_t carry = c.v[j] & x;
    c.v[j] ^= x;
    x = carry;
  }
}

// The warp's sum of its lanes' counters for replica `lane`; the counters
// are left at 0.  Each butterfly step adds two numbers of L levels into
// L + 1 levels, bit-sliced.
template <int kTree>
__device__ __forceinline__ uint32_t warp_count(Counter<kTree>& c,
                                               int lane) {
  constexpr int kL = kTree + kLevels;
  uint32_t s[kL + 5];
#pragma unroll
  for (int j = 0; j < kL; ++j) {
    s[j] = c.v[j];
    c.v[j] = 0;
  }
#pragma unroll
  for (int step = 0; step < 5; ++step) {
    uint32_t carry = 0;
#pragma unroll
    for (int j = 0; j < kL + step; ++j) {
      const uint32_t a = s[j];
      const uint32_t b = __shfl_xor_sync(kFull, a, 16 >> step);
      const uint32_t u = a ^ b;
      s[j] = u ^ carry;
      carry = (a & b) | (u & carry);
    }
    s[kL + step] = carry;
  }
  uint32_t count = 0;
#pragma unroll
  for (int j = 0; j < kL + 5; ++j) count |= ((s[j] >> lane) & 1u) << j;
  return count;
}

// A lane's 4 words of one row of both planes, and the word beyond the
// strip that its side tap needs where it is an edge lane.
struct Row {
  uint4 b, w;
  uint32_t edge;
};

__device__ __forceinline__ Row load_row(const uint32_t* black,
                                        const uint32_t* white, int row,
                                        int w, int col, bool valid,
                                        bool edge_lane, int edge_col) {
  Row r;
  const size_t base = static_cast<size_t>(row) * static_cast<size_t>(w);
  r.b = valid ? __ldg(reinterpret_cast<const uint4*>(black + base + col))
              : make_uint4(0, 0, 0, 0);
  r.w = valid ? __ldg(reinterpret_cast<const uint4*>(white + base + col))
              : make_uint4(0, 0, 0, 0);
  r.edge = edge_lane ? __ldg(white + base + edge_col) : 0u;
  return r;
}

// One row's counts into the counters: its 8 words of set bits, and the
// 16 bonds of its 4 black words (up and centre, the side tap of a row
// of parity kOdd) and of the 4 black words above it (down).
template <bool kOdd>
__device__ __forceinline__ void count_row(Counter<kUpTree>& up,
                                          Counter<kBondTree>& bond,
                                          const Row& above, const Row& row,
                                          bool valid, bool edge_lane) {
  const uint32_t b[4] = {row.b.x, row.b.y, row.b.z, row.b.w};
  const uint32_t w[4] = {row.w.x, row.w.y, row.w.z, row.w.w};
  // odd rows: (i, k+1), the next lane's first word; even rows: (i, k-1),
  // the previous lane's last word
  uint32_t edge = kOdd ? __shfl_down_sync(kFull, w[0], 1)
                       : __shfl_up_sync(kFull, w[3], 1);
  edge = edge_lane ? row.edge : (valid ? edge : 0u);
  const uint32_t side[4] = {kOdd ? w[1] : edge, kOdd ? w[2] : w[0],
                            kOdd ? w[3] : w[1], kOdd ? edge : w[2]};
  const uint32_t ab[4] = {above.b.x, above.b.y, above.b.z, above.b.w};
  const uint32_t aw[4] = {above.w.x, above.w.y, above.w.z, above.w.w};
  uint32_t bonds[16];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    bonds[j] = b[j] ^ aw[j];
    bonds[4 + j] = ab[j] ^ w[j];
    bonds[8 + j] = b[j] ^ w[j];
    bonds[12 + j] = b[j] ^ side[j];
  }
  ripple(bond, add16(bond.v, bonds));
  const uint32_t ups[8] = {b[0], b[1], b[2], b[3], w[0], w[1], w[2], w[3]};
  ripple(up, add8(up.v, ups));
}

// Member blockIdx.y; the launch's warp u = blockIdx.x * kWarps + warp
// takes run u / strips (rows [run * rows, run * rows + rows)) of strip
// u % strips.
__global__ void __launch_bounds__(kThreads) bitplane_counts_kernel(
    const uint32_t* __restrict__ black, const uint32_t* __restrict__ white,
    unsigned long long* __restrict__ out, int n, int w, int rows) {
  __shared__ unsigned long long sums[kWarps][2 * kReplicas];
  const int member = blockIdx.y;
  const size_t plane = repro_torch::member_offset(member, n, w);
  black += plane;
  white += plane;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int groups = w / 4;
  const int strips = (groups + 31) / 32;
  const int runs = (n + rows - 1) / rows;
  const int unit = blockIdx.x * kWarps + warp;
  unsigned long long up_total = 0, bond_total = 0;
  if (unit < strips * runs) {    // warp-uniform
    const int strip = unit % strips;
    const int g = strip * 32 + lane;
    const bool valid = g < groups;
    const int col = 4 * g;
    // the side tap's word beyond the strip: odd rows the next word,
    // wrapped, for the strip's last lane; even rows the previous one
    const bool edge_odd = valid && (lane == 31 || g == groups - 1);
    const bool edge_even = valid && lane == 0;
    const int col_odd = col + 4 == w ? 0 : col + 4;
    const int col_even = col == 0 ? w - 1 : col - 1;
    const int r0 = (unit / strips) * rows;    // even: rows is even
    const int r1 = min(n, r0 + rows);
    Counter<kUpTree> up = {};
    Counter<kBondTree> bond = {};
    Row above = load_row(black, white, r0 == 0 ? n - 1 : r0 - 1, w, col,
                         valid, false, 0);
    Row row = load_row(black, white, r0, w, col, valid, edge_even,
                       col_even);
    int counted = 0;
    for (int i = r0; i < r1; i += 2) {
      if (counted + 2 > kFlushRows) {
        up_total += warp_count(up, lane);
        bond_total += warp_count(bond, lane);
        counted = 0;
      }
      counted += 2;
      const bool odd_row = i + 1 < r1;
      Row next = load_row(black, white, odd_row ? i + 1 : i, w, col,
                          valid && odd_row, edge_odd && odd_row, col_odd);
      count_row<false>(up, bond, above, row, valid, edge_even);
      above = row;
      row = next;
      if (!odd_row) break;
      const bool even_row = i + 2 < r1;
      next = load_row(black, white, even_row ? i + 2 : i, w, col,
                      valid && even_row, edge_even && even_row, col_even);
      count_row<true>(up, bond, above, row, valid, edge_odd);
      above = row;
      row = next;
    }
    up_total += warp_count(up, lane);
    bond_total += warp_count(bond, lane);
  }
  sums[warp][lane] = up_total;
  sums[warp][kReplicas + lane] = bond_total;
  __syncthreads();
  if (threadIdx.x < 2 * kReplicas) {
    unsigned long long total = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) total += sums[k][threadIdx.x];
    if (total != 0) {
      atomicAdd(out + static_cast<size_t>(member) * 2 * kReplicas +
                    threadIdx.x,
                total);
    }
  }
}

// the card's SMs and the kernel's resident blocks an SM, by device
struct Occupancy {
  int sms = 0, blocks = 0;
};
Occupancy g_occupancy[64];

int occupancy(Occupancy* occ) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= 64) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  Occupancy& o = g_occupancy[device];
  if (o.sms == 0) {
    err = cudaDeviceGetAttribute(&o.sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &o.blocks, bitplane_counts_kernel, kThreads, 0);
    }
    if (err != cudaSuccess || o.blocks < 1) {
      o.sms = 0;
      return static_cast<int>(err != cudaSuccess ? err
                                                 : cudaErrorInvalidValue);
    }
  }
  *occ = o;
  return 0;
}

}  // namespace

extern "C" {

// black, white: `members` stacked (n, w) int32 word planes, 16-byte
// aligned, w a multiple of 4; out: (members, 2, 32) int64, zeroed, which
// the counts are added to
int bitplane_counts_launch(const void* black, const void* white, void* out,
                           int members, int n, int w, void* stream) {
  if (members < 1 || n < 1 || w < 4 || w % 4 != 0 ||
      !repro_torch::aligned(black, 16) || !repro_torch::aligned(white, 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Occupancy occ;
  const int err = occupancy(&occ);
  if (err != 0) return err;
  // runs of a strip for each member, so that the launch's warps are about
  // what the card holds at once: the runs' rows even and at least
  // kMinRows (or the plane's)
  const long long strips = (w / 4 + 31) / 32;
  const long long resident =
      static_cast<long long>(occ.sms) * occ.blocks * kWarps;
  long long runs = resident / members / strips;
  if (runs < 1) runs = 1;
  long long rows = (n + runs - 1) / runs;
  rows += rows & 1;
  if (rows < kMinRows) rows = kMinRows;
  runs = (n + rows - 1) / rows;
  const long long blocks = (strips * runs + kWarps - 1) / kWarps;
  if (blocks * kWarps > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t plane = static_cast<size_t>(n) * static_cast<size_t>(w);
  for (int lo = 0; lo < members; lo += kMaxGridY) {
    const int count = members - lo < kMaxGridY ? members - lo : kMaxGridY;
    const dim3 grid(static_cast<unsigned>(blocks), count, 1);
    bitplane_counts_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const uint32_t*>(black) + lo * plane,
        static_cast<const uint32_t*>(white) + lo * plane,
        static_cast<unsigned long long*>(out) + lo * 2 * kReplicas, n, w,
        static_cast<int>(rows));
    const cudaError_t launch = cudaGetLastError();
    if (launch != cudaSuccess) return static_cast<int>(launch);
  }
  return 0;
}

}  // extern "C"
