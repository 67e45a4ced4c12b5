// Fused tensor-core Metropolis half-sweep on the four sublattice planes,
// for Hopper (sm_90a).
//
// tensorcore_update replaces the Pallas kernel
// src/repro/kernels/tensorcore/tensorcore.py:tensorcore_update (paper
// S3.2, fused).  The lattice is four (h, w) planes '00', '01', '10', '11';
// a half-sweep updates the colour's two target planes t1, t2 (black: 00,
// 11; white: 10, 01) from the other two, a and b (black: 01, 10; white:
// 11, 00).  Within a tile the neighbour sums are banded products with
// K = I + superdiagonal:
//
//   black  nn1 = a K + K^T b     nn2 = b K^T + K   a
//   white  nn1 = a K + K   b     nn2 = b K^T + K^T a
//
// plus one value from the adjacent tile on the tile's edges (nn1: a's
// column left of the tile, and b's row above (black) or below (white);
// nn2: b's column right of it, and a's row below (black) or above
// (white); periodic wrap over the plane).  The sums are exact small
// integers whatever the tile, so the kernel's tile is its own: 64 rows
// (or 32, 16: the largest that divides h) by 128 columns (or 64, 32, 16),
// not the caller's tc_block, which only has to tile the planes.
//
// What bounds it on the card: per plane position (a site of each target
// plane) it moves 6 bytes of int8 planes (a and b read, t1 and t2 read
// and written), some 0.48 ms a half-sweep of four 16384^2 planes at
// 3.35 TB/s; and it draws lanes 0 and 1 of one Philox4x32-10 call, 16
// wide multiplies and one low half (philox_lane0.cuh), 33 FMA-pipe slots
// at the card's two slots a wide multiply: 0.52 SM clocks a position,
// about 0.53 ms (analysis/issue_rate.py measures 0.56 clocks); the
// tensor cores' share (about 200 FLOP a position) is 0.05 clocks.  So
// the floor is the issue of Philox, near that of the bytes.  Measured,
// the kernel spends
// about twice the floor: its parts add up instead of overlapping, the
// products' latency and the tile traffic beside Philox
// (analysis/ablate.py, PERF.md).  The design keeps what it can off the
// Philox path:
//  * Philox with the offset's work hoisted (philox_lane0.cuh,
//    HoistedPhilox::lanes01): the key schedule, round 0's product of the
//    offset and round 1's uniform product once a launch, on the host,
//    passed as a kernel parameter, so that the rounds read them as
//    uniform operands and hold no register for them; 17 products a
//    position (16 wide) for both target planes.
//  * A persistent grid, two blocks of 8 warps an SM, each walking tiles
//    with stride gridDim.x through a ring of two stages in shared memory.
//    Every thread issues its 16-byte cp.async copies of the next tile
//    (a, b, t1, t2 and the pieces holding the edge vectors) before it
//    converts and updates this one, so the loads run under the products
//    and the accept.
//  * The spin operands are converted on the consumer side, int8 -> bf16,
//    into XOR-swizzled shared rows (ldmatrix needs 16-bit elements); the
//    products run on the tensor cores, mma.sync m16n8k16 bf16 -> f32, the
//    spin operand through ldmatrix (.trans where the spins are the column
//    operand), the K operand a fragment of each lane, made once a launch
//    into shared memory; only the k-steps whose K tile is not all zero
//    run.  A warp owns a band of 16 rows and a run of 16 x 8 output
//    tiles, two at a step.  The edge terms are products too: the k-steps
//    past the tile's edge read small halos (a's 8 columns left of the
//    tile, b's 8 right of it, each operand's edge row), where K has its
//    one non-zero, so no lane branches on the tile's edge.  Each lane's
//    ldmatrix rows are fixed addresses; a step adds (2 k) ^ swizzle.
//  * The accept stays in the accumulator layout (rows lane/4 (+8),
//    columns 2 (lane%4) (+1)), on the target pairs in the stage, read and
//    written in place, the stage's rows XOR-swizzled in 16-byte pieces so
//    the 8 rows of a warp's access fall in different banks.  A spin flips
//    iff draw < bound[(s > 0) * 5 + (nn + 4) / 2], 64-bit exclusive
//    bounds the host derives from the 10-entry float32 table
//    (repro_torch.core.metropolis.draw_bounds: 0 never flips, an entry
//    that underflowed to 0 included; 2^32 always, p > 1).  The products
//    start from 2^23 + 2^22 + 4 (+ 10 where the spin is up), so the sum's
//    low mantissa bits are the bound's index without a conversion or an
//    add (every partial sum is an exact integer below 2^24).
//  * The targets go back to device memory in whole 16-byte pieces, each
//    warp its own rows as soon as it has updated them.
// Draws are keyed on the global position: lane 0 (t1) and lane 1 (t2) of
// Philox at counter (offset, 0, i * w + j, 0), key (seed mod 2^32, 0).
// Spins must be +-1: the kernel flips them by their sign bits.
//
// The kernel is a template on the plane type -- int8 (the engine's state)
// and bf16 (the TPU kernel's contract), held as its 16-bit pattern -- and
// on its tile.
//
// Planes whose sides are not both multiples of 16 (a 48^2 lattice's 24 x
// 24 planes) have no tile of whole 16-byte rows and mma steps; they take
// tensorcore_sites_kernel, one thread a plane position: the same four
// neighbours a sum, the same draws and the same accept, without the
// products.  Such planes are small, so it is written for being right,
// not fast.  The caller's tc_block is then any block that tiles the
// planes, as it is for the TPU kernel.

#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "philox_lane0.cuh"
#include "ptx.cuh"

namespace {

using repro_torch::cp_async16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTableSize = 10;
constexpr int kStages = 2;

// The accept as exclusive bounds on the raw draw: flip iff bits < v[i],
// which is u < table[i] for u = float(bits) 2^-32 (see
// repro_torch.core.metropolis.draw_bounds).  64 bits hold both ends: 0
// where no draw flips (the entry underflowed to 0) and 2^32 where every
// draw flips.
struct DrawBounds {
  uint64_t v[kTableSize];
};

// Spins are +-1.  Spin<T> reads and flips element k (0 or 1) of a pair of
// horizontally adjacent spins held in one word: int8 bytes, or bf16 bit
// patterns.
template <class T>
struct Spin;

template <>
struct Spin<int8_t> {
  using Pair = uint16_t;
  __device__ static bool positive(uint32_t pair, int k) {
    return ((pair >> (8 * k + 7)) & 1u) == 0u;
  }
  // -1 = 0xFF and +1 = 0x01 differ in 0xFE
  __device__ static uint32_t flip_mask(int k) { return 0xFEu << (8 * k); }
};

template <>
struct Spin<uint16_t> {
  using Pair = uint32_t;
  __device__ static bool positive(uint32_t pair, int k) {
    return ((pair >> (16 * k + 15)) & 1u) == 0u;
  }
  __device__ static uint32_t flip_mask(int k) { return 0x8000u << (16 * k); }
};

__device__ __forceinline__ uint32_t pack(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// Two int8 spins (+-1, bytes k and k + 1 of w) as a bf16 pair: 1.0 is
// 0x3F80, the sign bit comes from bit 7 of the byte.
__device__ __forceinline__ uint32_t bf16_pair(uint32_t w, int k) {
  const uint32_t b = w >> (8 * k);
  return 0x3F803F80u | ((b & 0x80u) << 8) | ((b & 0x8000u) << 16);
}

// K[p][q] as a bf16 bit pattern: 1 on the diagonal and the superdiagonal
__device__ __forceinline__ uint16_t band(int p, int q) {
  return (q == p || q == p + 1) ? 0x3F80u : 0u;
}

// The column-operand fragment (16 x 8, k x n) of K or K^T for a k-step
// at d = c0 - k0 from the output tile: thread (g, t) holds rows 2t,
// 2t + 1 (+ 8) of column g.
struct ColFrag {
  uint32_t r[2];
};

// The row-operand fragment (16 x 16, m x k) of K or K^T for a k-step at
// d = k0 - r0: thread (g, t) holds rows g (+ 8), columns 2t, 2t + 1 (+ 8).
struct RowFrag {
  uint32_t r[4];
};

// x K: column operand K[j][c] = band(j, c)
__device__ __forceinline__ ColFrag col_k(int d, int g, int t) {
  ColFrag f;
  for (int h = 0; h < 2; ++h) {
    const int j = 2 * t + 8 * h;
    f.r[h] = pack(band(j, g + d), band(j + 1, g + d));
  }
  return f;
}

// x K^T: column operand K^T[j][c] = K[c][j] = band(c, j)
__device__ __forceinline__ ColFrag col_kt(int d, int g, int t) {
  ColFrag f;
  for (int h = 0; h < 2; ++h) {
    const int j = 2 * t + 8 * h;
    f.r[h] = pack(band(g + d, j), band(g + d, j + 1));
  }
  return f;
}

// K x (kt false) or K^T x (kt true): row operand K[r][j] = band(r, j) or
// K^T[r][j] = band(j, r); register order (g, 2t), (g + 8, 2t),
// (g, 2t + 8), (g + 8, 2t + 8)
__device__ __forceinline__ RowFrag row_k(bool kt, int d, int g, int t) {
  RowFrag f;
  for (int i = 0; i < 4; ++i) {
    const int r = g + 8 * (i & 1);
    const int j = 2 * t + 8 * (i >> 1) + d;
    f.r[i] = kt ? pack(band(j, r), band(j + 1, r))
                : pack(band(r, j), band(r, j + 1));
  }
  return f;
}

// Rows of kChunks 16-byte chunks, chunk c of row r stored at chunk
// c ^ (r & kMask): 8 consecutive rows at one chunk (what ldmatrix reads
// together, and the accept's accesses to the rows g of a warp) land in
// different banks without padding.
template <int kChunks>
struct Swizzle {
  static constexpr int kMask = (kChunks < 8 ? kChunks : 8) - 1;
  __device__ static int chunk(int r, int c) { return c ^ (r & kMask); }
};

// The kernel's tile, TR x TC elements of each plane, and how it lies in
// shared memory and over the warps.
template <class T, int TR, int TC>
struct Tile {
  static_assert(TR % 16 == 0 && TC % 16 == 0 && TR >= 16 && TR <= 128 &&
                    TC >= 16 && TC <= 128,
                "tile");
  static constexpr int kVec = 16 / sizeof(T);      // elements a piece
  static constexpr int kRowBytes = TC * sizeof(T);
  static constexpr int kRowPieces = kRowBytes / 16;
  static constexpr int kPieces = TR * kRowPieces;  // 16-byte pieces a plane
  static constexpr int kPlane = TR * kRowBytes;
  // a stage: raw a, b, t1, t2 (the targets' pieces swizzled); the
  // 16-byte pieces that end at a's element left of each row and start at
  // b's element right of it; the vertical edge rows of b (nn1) and a
  // (nn2)
  static constexpr int kSide1 = 4 * kPlane;
  static constexpr int kSide2 = kSide1 + 16 * TR;
  static constexpr int kVert1 = kSide2 + 16 * TR;
  static constexpr int kVert2 = kVert1 + kRowBytes;
  static constexpr int kStage = kVert2 + kRowBytes;
  // after the stages, as bf16: a and b swizzled; the halos of the
  // products -- a's 8 columns left of the tile and b's 8 right of it (16
  // bytes a row), a's and b's edge rows (TC values each); then each
  // lane's K fragments (6 column operands of 8 bytes, 4 row operands of
  // 16, lane-minor) and the draw bounds
  static constexpr int kXa = kStages * kStage;
  static constexpr int kXb = kXa + 2 * TR * TC;
  static constexpr int kHaloA = kXb + 2 * TR * TC;
  static constexpr int kHaloB = kHaloA + 16 * TR;
  static constexpr int kRowA = kHaloB + 16 * TR;
  static constexpr int kRowB = kRowA + 2 * TC;
  static constexpr int kColFrags = kRowB + 2 * TC;
  static constexpr int kRowFrags = kColFrags + 6 * 32 * 8;
  static constexpr int kBounds = kRowFrags + 4 * 32 * 16;
  static constexpr size_t kSmem = kBounds + 8 * kTableSize;
  // warps: bands of 16 rows, a band's TC / 8 column tiles split over
  // kWpb warps, at least a pair of column tiles (16 bytes of an int8 row)
  // a warp
  static constexpr int kBands = TR / 16;
  static constexpr int kWpb =
      (kWarps / kBands < TC / 16) ? kWarps / kBands : TC / 16;
  static constexpr int kActive = kBands * kWpb;
  static constexpr int kTiles = (TC / 8) / kWpb;   // column tiles a warp
  static constexpr int kWarpRowPieces = kTiles * 8 * sizeof(T) / 16;
  static constexpr int kWarpPieces = 16 * kWarpRowPieces;  // a target
  static_assert((TC / 8) % kWpb == 0 && kTiles % 2 == 0, "warps");
};

// The accept's bound for the sum that came out of the products: they
// start at 2^23 + 2^22 + 4 (+ 10 where the target spin is up), so the
// float's low mantissa bits hold nn + 4 (+ 10), twice the index of the
// entry (s > 0) * 5 + (nn + 4) / 2, and 4 times them its byte offset.
__device__ __forceinline__ uint64_t bound_of(const unsigned char* bounds,
                                             float sum) {
  return *reinterpret_cast<const uint64_t*>(
      bounds + 4u * (__float_as_uint(sum) - 0x4B400000u));
}

template <class T>
__device__ __forceinline__ float sum_start(uint32_t pair, int k) {
  return Spin<T>::positive(pair, k) ? 12582926.0f : 12582916.0f;
}

// Persistent: grid of at most (blocks an SM) x (SMs), kThreads threads; a
// block takes tiles blockIdx.x, blockIdx.x + gridDim.x, ... of the
// (h / TR) x (w / TC) tiles, row-major.
template <class T, int TR, int TC>
__global__ void __launch_bounds__(kThreads, 2)
    tensorcore_update_kernel(T* __restrict__ t1, T* __restrict__ t2,
                             const T* __restrict__ a,
                             const T* __restrict__ b, int h, int w,
                             int is_black, DrawBounds bounds,
                             const repro_torch::HoistedPhilox philox) {
  using L = Tile<T, TR, TC>;
  using Pair = typename Spin<T>::Pair;
  using SwX = Swizzle<TC / 8>;            // the bf16 operand rows
  using SwT = Swizzle<L::kRowPieces>;     // the raw target rows
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int tiles_x = w / TC;
  const int tiles = (h / TR) * tiles_x;
  const bool black = is_black != 0;
  if (tid < kTableSize) {
    reinterpret_cast<uint64_t*>(smem + L::kBounds)[tid] = bounds.v[tid];
  }
  // each lane's K fragments, one per offset between output tile and
  // k-step.  Column operand: x K at d = c0 - k0 in {0, 8, 16}; x K^T at d
  // in {0, 8, -8}.  Row operand: nn1 takes K^T b (black) / K b (white),
  // nn2 K a (black) / K^T a (white), each at k0 = r0 and at the other
  // band they reach: r0 - 16 for K^T, r0 + 16 for K.
  const int d1 = black ? -16 : 16;         // nn1's second k-step; nn2's -d1
  if (warp == 0) {
    uint2* cf = reinterpret_cast<uint2*>(smem + L::kColFrags);
    uint4* rf = reinterpret_cast<uint4*>(smem + L::kRowFrags);
    const ColFrag c[6] = {col_k(0, g, t),   col_k(8, g, t),
                          col_k(16, g, t),  col_kt(0, g, t),
                          col_kt(8, g, t),  col_kt(-8, g, t)};
    const RowFrag r[4] = {row_k(black, 0, g, t), row_k(black, d1, g, t),
                          row_k(!black, 0, g, t),
                          row_k(!black, -d1, g, t)};
    for (int i = 0; i < 6; ++i) {
      cf[32 * i + lane] = make_uint2(c[i].r[0], c[i].r[1]);
    }
    for (int i = 0; i < 4; ++i) {
      rf[32 * i + lane] =
          make_uint4(r[i].r[0], r[i].r[1], r[i].r[2], r[i].r[3]);
    }
  }

  // every copy of one tile into a stage, as one cp.async group
  auto fetch = [&](int tile, unsigned char* st) {
    const int row0 = (tile / tiles_x) * TR;
    const int col0 = (tile % tiles_x) * TC;
    constexpr int kIters = (L::kPieces + kThreads - 1) / kThreads;
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      const int p = tid + i * kThreads;
      if (L::kPieces % kThreads == 0 || p < L::kPieces) {
        const int r = p / L::kRowPieces;
        const int c = p % L::kRowPieces;
        const size_t at =
            static_cast<size_t>(row0 + r) * w + col0 + c * L::kVec;
        unsigned char* row = st + r * L::kRowBytes;
        const int swz = SwT::chunk(r, c) * 16;
        cp_async16(row + c * 16, a + at);
        cp_async16(row + L::kPlane + c * 16, b + at);
        cp_async16(row + 2 * L::kPlane + swz, t1 + at);
        cp_async16(row + 3 * L::kPlane + swz, t2 + at);
      }
    }
    // a's element left of row r is the last of the piece that ends there,
    // b's right of it the first of the piece that starts there
    const int left = (col0 == 0 ? w : col0) - L::kVec;
    const int right = col0 + TC == w ? 0 : col0 + TC;
    for (int r = tid; r < TR; r += kThreads) {
      const size_t row = static_cast<size_t>(row0 + r) * w;
      cp_async16(st + L::kSide1 + 16 * r, a + row + left);
      cp_async16(st + L::kSide2 + 16 * r, b + row + right);
    }
    const int above = row0 == 0 ? h - 1 : row0 - 1;
    const int below = row0 + TR == h ? 0 : row0 + TR;
    const T* v1 = b + static_cast<size_t>(black ? above : below) * w + col0;
    const T* v2 = a + static_cast<size_t>(black ? below : above) * w + col0;
    for (int c = tid; c < L::kRowPieces; c += kThreads) {
      cp_async16(st + L::kVert1 + 16 * c, v1 + c * L::kVec);
      cp_async16(st + L::kVert2 + 16 * c, v2 + c * L::kVec);
    }
    repro_torch::cp_async_commit();
  };

  // The shared-memory addresses of this lane's ldmatrix rows: row
  // r0 + (lane & 15) of a band, the second 8 columns of a k-step for
  // lanes 16 to 31 (hi), swizzled; a k-step at column k is at
  // row + ((2 k) ^ swz).  The second k-step of nn1's column product is
  // b's band d1 rows away, or at the tile's edge b's edge row (every lane
  // at the one row: K has one non-zero there); nn2's a's band -d1 away,
  // or a's edge row.  Left of the tile a's k-step is a's column halo,
  // right of it b's (every lane at its row's 16 bytes).
  const int r0 = (warp / L::kWpb) * 16;
  const int first_tile = (warp % L::kWpb) * L::kTiles;
  const int row = r0 + (lane & 15);
  const int hi = lane >> 4;
  const uint32_t base = repro_torch::shared_address(smem);
  const uint32_t swz = static_cast<uint32_t>(hi ^ (row & SwX::kMask)) << 4;
  const uint32_t xa_row = base + L::kXa + row * 2 * TC;
  const uint32_t xb_row = base + L::kXb + row * 2 * TC;
  const bool edge1 = r0 + d1 < 0 || r0 + d1 >= TR;
  const bool edge2 = r0 - d1 < 0 || r0 - d1 >= TR;
  const uint32_t b_x = edge1 ? base + L::kRowB : xb_row + d1 * 2 * TC;
  const uint32_t b_x_swz = edge1 ? static_cast<uint32_t>(hi) << 4 : swz;
  const uint32_t a_x = edge2 ? base + L::kRowA : xa_row - d1 * 2 * TC;
  const uint32_t a_x_swz = edge2 ? static_cast<uint32_t>(hi) << 4 : swz;
  const uint32_t a_left = base + L::kHaloA + 16 * row;
  const uint32_t b_right = base + L::kHaloB + 16 * row;
  const uint32_t rows8 = 8u * static_cast<uint32_t>(w);
  const int tsw = (r0 + g) & SwT::kMask;   // rows g and g + 8 alike
  const uint2* cf = reinterpret_cast<const uint2*>(smem + L::kColFrags);
  const uint4* rf = reinterpret_cast<const uint4*>(smem + L::kRowFrags);
  const unsigned char* bound = smem + L::kBounds;

  int tile = blockIdx.x;
  if (tile < tiles) fetch(tile, smem);
  for (int i = 0; tile < tiles; ++i, tile += gridDim.x) {
    unsigned char* st = smem + (i & 1) * L::kStage;
    repro_torch::cp_async_wait_all();
    // the tile has landed, and every warp is done with the last one
    __syncthreads();
    if (tile + static_cast<int>(gridDim.x) < tiles) {
      fetch(tile + gridDim.x, smem + ((i + 1) & 1) * L::kStage);
    }

    // -- a and b as swizzled bf16, and the halos -------------------------
    constexpr int kIters = (L::kPieces + kThreads - 1) / kThreads;
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int p = tid + it * kThreads;
      if (L::kPieces % kThreads == 0 || p < L::kPieces) {
        const int r = p / L::kRowPieces;
        const int c = p % L::kRowPieces;
        const unsigned char* from = st + r * L::kRowBytes + c * 16;
        const uint4 va = *reinterpret_cast<const uint4*>(from);
        const uint4 vb = *reinterpret_cast<const uint4*>(from + L::kPlane);
        unsigned char* xa = smem + L::kXa + r * 2 * TC;
        unsigned char* xb = xa + L::kXb - L::kXa;
        if constexpr (sizeof(T) == 2) {
          *reinterpret_cast<uint4*>(xa + 16 * SwX::chunk(r, c)) = va;
          *reinterpret_cast<uint4*>(xb + 16 * SwX::chunk(r, c)) = vb;
        } else {
          const uint32_t wa[4] = {va.x, va.y, va.z, va.w};
          const uint32_t wb[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int at = 16 * SwX::chunk(r, 2 * c + half);
            const uint32_t a0 = wa[2 * half], a1 = wa[2 * half + 1];
            const uint32_t b0 = wb[2 * half], b1 = wb[2 * half + 1];
            *reinterpret_cast<uint4*>(xa + at) =
                make_uint4(bf16_pair(a0, 0), bf16_pair(a0, 2),
                           bf16_pair(a1, 0), bf16_pair(a1, 2));
            *reinterpret_cast<uint4*>(xb + at) =
                make_uint4(bf16_pair(b0, 0), bf16_pair(b0, 2),
                           bf16_pair(b1, 0), bf16_pair(b1, 2));
          }
        }
      }
    }
    // a's 8 elements left of row r (the last of its side piece) and b's 8
    // right of it (the first), as bf16
    for (int r = tid; r < TR; r += kThreads) {
      const uint4 l = *reinterpret_cast<const uint4*>(st + L::kSide1 + 16 * r);
      const uint4 q = *reinterpret_cast<const uint4*>(st + L::kSide2 + 16 * r);
      uint4* to_a = reinterpret_cast<uint4*>(smem + L::kHaloA + 16 * r);
      uint4* to_b = reinterpret_cast<uint4*>(smem + L::kHaloB + 16 * r);
      if constexpr (sizeof(T) == 2) {
        *to_a = l;
        *to_b = q;
      } else {
        *to_a = make_uint4(bf16_pair(l.z, 0), bf16_pair(l.z, 2),
                           bf16_pair(l.w, 0), bf16_pair(l.w, 2));
        *to_b = make_uint4(bf16_pair(q.x, 0), bf16_pair(q.x, 2),
                           bf16_pair(q.y, 0), bf16_pair(q.y, 2));
      }
    }
    // the edge rows: b's above (black) / below (white), a's the other
    for (int c = tid; c < 2 * L::kRowPieces; c += kThreads) {
      const int plane = c / L::kRowPieces, q = c % L::kRowPieces;
      const uint4 v = *reinterpret_cast<const uint4*>(
          st + (plane ? L::kVert2 : L::kVert1) + 16 * q);
      unsigned char* to = smem + (plane ? L::kRowA : L::kRowB);
      if constexpr (sizeof(T) == 2) {
        *reinterpret_cast<uint4*>(to + 16 * q) = v;
      } else {
        *reinterpret_cast<uint4*>(to + 32 * q) =
            make_uint4(bf16_pair(v.x, 0), bf16_pair(v.x, 2),
                       bf16_pair(v.y, 0), bf16_pair(v.y, 2));
        *reinterpret_cast<uint4*>(to + 32 * q + 16) =
            make_uint4(bf16_pair(v.z, 0), bf16_pair(v.z, 2),
                       bf16_pair(v.w, 0), bf16_pair(v.w, 2));
      }
    }
    __syncthreads();
    if (warp >= L::kActive) continue;

    // -- products, draws and the accept, a pair of column tiles a step ---
    const int row0 = (tile / tiles_x) * TR;
    const int col0 = (tile % tiles_x) * TC;
    unsigned char* s1 = st + 2 * L::kPlane + (r0 + g) * L::kRowBytes;
    unsigned char* s2 = s1 + L::kPlane;
    // the global position of this thread's element 0 at column tile 0
    const uint32_t site0 =
        static_cast<uint32_t>(row0 + r0 + g) * static_cast<uint32_t>(w) +
        static_cast<uint32_t>(col0 + 2 * t);
#pragma unroll 1
    for (int ct = first_tile; ct < first_tile + L::kTiles; ct += 2) {
      const int c0 = ct * 8;
      const uint32_t k2 = 2u * c0;
      // the targets: rows g, g + 8 of the band, columns c0 + 2t (+ 1) of
      // the even column tile (e = 0) and c0 + 8 + 2t (+ 1) of the odd one,
      // at their swizzled offsets; the sums start from their spins
      int at[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int byte = (c0 + 8 * e + 2 * t) * static_cast<int>(sizeof(T));
        at[e] = (((byte >> 4) ^ tsw) << 4) + (byte & 15);
      }
      uint32_t p1[2][2], p2[2][2];
      float n1[2][4], n2[2][4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          p1[e][hr] = *reinterpret_cast<const Pair*>(s1 + at[e] +
                                                     8 * hr * L::kRowBytes);
          p2[e][hr] = *reinterpret_cast<const Pair*>(s2 + at[e] +
                                                     8 * hr * L::kRowBytes);
        }
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          n1[e][x] = sum_start<T>(p1[e][x >> 1], x & 1);
          n2[e][x] = sum_start<T>(p2[e][x >> 1], x & 1);
        }
      }
      // nn1 = a K + (K^T | K) b, nn2 = b K^T + (K | K^T) a
      uint32_t f[4], y[4];
      uint2 kc = cf[lane];
      uint32_t kk[2] = {kc.x, kc.y};
      repro_torch::ldmatrix_x4(f, xa_row + (k2 ^ swz));
      repro_torch::mma_bf16_16816(n1[0], f, kk);
      kc = cf[32 + lane];
      kk[0] = kc.x, kk[1] = kc.y;
      repro_torch::mma_bf16_16816(n1[1], f, kk);
      repro_torch::ldmatrix_x4(
          f, c0 == 0 ? a_left : xa_row + ((k2 - 32) ^ swz));
      kc = cf[64 + lane];
      kk[0] = kc.x, kk[1] = kc.y;
      repro_torch::mma_bf16_16816(n1[0], f, kk);
      repro_torch::ldmatrix_x4(f, xb_row + (k2 ^ swz));
      kc = cf[96 + lane];
      kk[0] = kc.x, kk[1] = kc.y;
      repro_torch::mma_bf16_16816(n2[0], f, kk);
      kc = cf[128 + lane];
      kk[0] = kc.x, kk[1] = kc.y;
      repro_torch::mma_bf16_16816(n2[1], f, kk);
      repro_torch::ldmatrix_x4(
          f, c0 + 16 == TC ? b_right : xb_row + ((k2 + 32) ^ swz));
      kc = cf[160 + lane];
      kk[0] = kc.x, kk[1] = kc.y;
      repro_torch::mma_bf16_16816(n2[1], f, kk);
      uint4 kr = rf[lane];
      uint32_t kx[4] = {kr.x, kr.y, kr.z, kr.w};
      repro_torch::ldmatrix_x4_trans(y, xb_row + (k2 ^ swz));
      repro_torch::mma_bf16_16816(n1[0], kx, y);
      repro_torch::mma_bf16_16816(n1[1], kx, y + 2);
      kr = rf[32 + lane];
      kx[0] = kr.x, kx[1] = kr.y, kx[2] = kr.z, kx[3] = kr.w;
      repro_torch::ldmatrix_x4_trans(y, b_x + (k2 ^ b_x_swz));
      repro_torch::mma_bf16_16816(n1[0], kx, y);
      repro_torch::mma_bf16_16816(n1[1], kx, y + 2);
      kr = rf[64 + lane];
      kx[0] = kr.x, kx[1] = kr.y, kx[2] = kr.z, kx[3] = kr.w;
      repro_torch::ldmatrix_x4_trans(y, xa_row + (k2 ^ swz));
      repro_torch::mma_bf16_16816(n2[0], kx, y);
      repro_torch::mma_bf16_16816(n2[1], kx, y + 2);
      kr = rf[96 + lane];
      kx[0] = kr.x, kx[1] = kr.y, kx[2] = kr.z, kx[3] = kr.w;
      repro_torch::ldmatrix_x4_trans(y, a_x + (k2 ^ a_x_swz));
      repro_torch::mma_bf16_16816(n2[0], kx, y);
      repro_torch::mma_bf16_16816(n2[1], kx, y + 2);
      // draws: element x of column tile e is row r0 + g (+ 8 for x >= 2),
      // column c0 + 8 e + 2t (+ 1 for odd x)
      const uint32_t site = site0 + static_cast<uint32_t>(c0);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int hr = x >> 1, k = x & 1;
          const uint2 d = philox.lanes01(site + 8u * e + (hr ? rows8 : 0u) +
                                         static_cast<uint32_t>(k));
          if (d.x < bound_of(bound, n1[e][x])) {
            p1[e][hr] ^= Spin<T>::flip_mask(k);
          }
          if (d.y < bound_of(bound, n2[e][x])) {
            p2[e][hr] ^= Spin<T>::flip_mask(k);
          }
        }
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          *reinterpret_cast<Pair*>(s1 + at[e] + 8 * hr * L::kRowBytes) =
              static_cast<Pair>(p1[e][hr]);
          *reinterpret_cast<Pair*>(s2 + at[e] + 8 * hr * L::kRowBytes) =
              static_cast<Pair>(p2[e][hr]);
        }
      }
    }
    __syncwarp();
    // -- the warp's rows of both targets back, 16 bytes a piece ----------
    constexpr int kOut = 2 * L::kWarpPieces / 32;
    static_assert((2 * L::kWarpPieces) % 32 == 0, "write-back");
#pragma unroll
    for (int it = 0; it < kOut; ++it) {
      const int p = lane + 32 * it;
      const int plane = p / L::kWarpPieces;
      const int q = p % L::kWarpPieces;
      const int r = r0 + q / L::kWarpRowPieces;
      const int c = first_tile * 8 * static_cast<int>(sizeof(T)) / 16 +
                    q % L::kWarpRowPieces;
      const uint4 v = *reinterpret_cast<const uint4*>(
          st + (2 + plane) * L::kPlane + r * L::kRowBytes +
          16 * SwT::chunk(r, c));
      T* to = (plane ? t2 : t1) + static_cast<size_t>(row0 + r) * w + col0 +
              c * L::kVec;
      *reinterpret_cast<uint4*>(to) = v;
    }
  }
}

// The spin +-1 of an element, and the element with its spin flipped
__device__ __forceinline__ int spin_of(int8_t v) { return v; }
__device__ __forceinline__ int spin_of(uint16_t v) {
  return (v & 0x8000u) ? -1 : 1;
}
__device__ __forceinline__ int8_t flipped(int8_t v) {
  return static_cast<int8_t>(-v);
}
__device__ __forceinline__ uint16_t flipped(uint16_t v) {
  return static_cast<uint16_t>(v ^ 0x8000u);
}

// The half-sweep one plane position a thread (grid-stride), for planes
// the tiles do not fit: nn1 = a[i, j] + a[i, j - 1] + b[i, j] + b's row
// above (black) or below (white); nn2 = b[i, j] + b[i, j + 1] + a[i, j] +
// a's row below (black) or above (white), periodic; lane 0 of the draw
// at site i w + j decides t1, lane 1 t2.  t1 and t2 are neither read for
// a sum nor written by another thread, so the update is in place.
template <class T>
__global__ void __launch_bounds__(kThreads)
    tensorcore_sites_kernel(T* __restrict__ t1, T* __restrict__ t2,
                            const T* __restrict__ a,
                            const T* __restrict__ b, int h, int w,
                            int is_black, DrawBounds bounds,
                            const repro_torch::HoistedPhilox philox) {
  const int64_t n = static_cast<int64_t>(h) * w;
  const int down1 = is_black ? h - 1 : 1;  // nn1's row of b, mod h
  const int down2 = h - down1;             // nn2's row of a, mod h
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       p < n; p += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int i = static_cast<int>(p / w), j = static_cast<int>(p % w);
    const int64_t row = static_cast<int64_t>(i) * w;
    const int left = j == 0 ? w - 1 : j - 1;
    const int right = j + 1 == w ? 0 : j + 1;
    const int sa = spin_of(a[p]), sb = spin_of(b[p]);
    const int nn1 = sa + spin_of(a[row + left]) + sb +
                    spin_of(b[static_cast<int64_t>((i + down1) % h) * w + j]);
    const int nn2 = sb + spin_of(b[row + right]) + sa +
                    spin_of(a[static_cast<int64_t>((i + down2) % h) * w + j]);
    const uint2 d = philox.lanes01(static_cast<uint32_t>(p));
    const T s1 = t1[p], s2 = t2[p];
    if (d.x < bounds.v[(spin_of(s1) > 0) * 5 + (nn1 + 4) / 2]) {
      t1[p] = flipped(s1);
    }
    if (d.y < bounds.v[(spin_of(s2) > 0) * 5 + (nn2 + 4) / 2]) {
      t2[p] = flipped(s2);
    }
  }
}

// The kernel's tile for (h, w): the largest of 64, 32, 16 rows dividing h
// and of 128, 64, 32, 16 columns dividing w.
inline int tile_rows(int h) {
  return h % 64 == 0 ? 64 : h % 32 == 0 ? 32 : 16;
}
inline int tile_cols(int w) {
  return w % 128 == 0 ? 128 : w % 64 == 0 ? 64 : w % 32 == 0 ? 32 : 16;
}

constexpr int kMaxDevices = 64;  // cards whose grid size prepare keeps

// The persistent grid's size for (h, w) planes: the tiles, at most the
// blocks that fit on the card's SMs at once.  Those blocks depend only on
// the instance and the card, so they are worked out at the instance's
// first launch on each card (the shared-memory attributes set there
// stay set) and only the tiles per launch.
template <class T, int TR, int TC>
cudaError_t prepare(int h, int w, int* grid) {
  using L = Tile<T, TR, TC>;
  static int blocks_on[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess && device >= kMaxDevices) err = cudaErrorInvalidDevice;
  if (err == cudaSuccess && blocks_on[device] == 0) {
    const auto kernel = tensorcore_update_kernel<T, TR, TC>;
    int per_sm = 0, sms = 0;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(L::kSmem));
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, kThreads, L::kSmem);
    }
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    }
    if (err == cudaSuccess) blocks_on[device] = (per_sm > 0 ? per_sm : 1) * sms;
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch would report it
    return err;
  }
  const int tiles = (h / TR) * (w / TC);
  *grid = tiles < blocks_on[device] ? tiles : blocks_on[device];
  return cudaSuccess;
}

struct Args {
  void* t1;
  void* t2;
  const void* a;
  const void* b;
  int h;
  int w;
  int is_black;
  DrawBounds bounds;
  uint32_t key;
  uint32_t offset;
  cudaStream_t stream;
};

template <class T, int TR, int TC>
int launch(const Args& x) {
  int grid = 0;
  const cudaError_t err = prepare<T, TR, TC>(x.h, x.w, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the draws' constants of this launch, made once on the host: key
  // (seed mod 2^32, 0), as the TPU kernel keys
  const repro_torch::HoistedPhilox philox(x.offset, x.key, 0u);
  tensorcore_update_kernel<T, TR, TC>
      <<<grid, kThreads, Tile<T, TR, TC>::kSmem, x.stream>>>(
          static_cast<T*>(x.t1), static_cast<T*>(x.t2),
          static_cast<const T*>(x.a), static_cast<const T*>(x.b), x.h, x.w,
          x.is_black, x.bounds, philox);
  return static_cast<int>(cudaGetLastError());
}

// launch (grid null) or the persistent grid's size (into *grid) of the
// kernel at tile rows x cols
template <class T>
int dispatch(int rows, int cols, const Args& x, int* grid) {
#define REPRO_TC_TILE(R, C)                                              \
  if (rows == R && cols == C) {                                          \
    return grid ? static_cast<int>(prepare<T, R, C>(x.h, x.w, grid))     \
                : launch<T, R, C>(x);                                    \
  }
  REPRO_TC_TILE(64, 128)
  REPRO_TC_TILE(64, 64)
  REPRO_TC_TILE(64, 32)
  REPRO_TC_TILE(64, 16)
  REPRO_TC_TILE(32, 128)
  REPRO_TC_TILE(32, 64)
  REPRO_TC_TILE(32, 32)
  REPRO_TC_TILE(32, 16)
  REPRO_TC_TILE(16, 128)
  REPRO_TC_TILE(16, 64)
  REPRO_TC_TILE(16, 32)
  REPRO_TC_TILE(16, 16)
#undef REPRO_TC_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}

// tensorcore_sites_kernel over (h, w) planes whose sides are not both
// multiples of 16
template <class T>
int launch_sites(const Args& x) {
  const int64_t n = static_cast<int64_t>(x.h) * x.w;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  const repro_torch::HoistedPhilox philox(x.offset, x.key, 0u);
  tensorcore_sites_kernel<T>
      <<<static_cast<int>(blocks < 4096 ? blocks : 4096), kThreads, 0,
         x.stream>>>(static_cast<T*>(x.t1), static_cast<T*>(x.t2),
                     static_cast<const T*>(x.a), static_cast<const T*>(x.b),
                     x.h, x.w, x.is_black, x.bounds, philox);
  return static_cast<int>(cudaGetLastError());
}

bool tiled(int h, int w) { return h % 16 == 0 && w % 16 == 0; }

int run(int rows, int cols, int elem_bytes, const Args& x, int* grid) {
  if (rows <= 0 || cols <= 0 || x.h % rows != 0 || x.w % cols != 0 ||
      (elem_bytes != 1 && elem_bytes != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return elem_bytes == 1 ? dispatch<int8_t>(rows, cols, x, grid)
                         : dispatch<uint16_t>(rows, cols, x, grid);
}

Args make_args(void* t1, void* t2, const void* a, const void* b, int h,
               int w, int is_black, const uint64_t* draw_bounds,
               uint32_t key, uint32_t offset, void* stream) {
  Args x{t1, t2, a, b, h, w, is_black, {}, key, offset,
         static_cast<cudaStream_t>(stream)};
  if (draw_bounds) {
    for (int i = 0; i < kTableSize; ++i) x.bounds.v[i] = draw_bounds[i];
  }
  return x;
}

bool valid_block(int h, int w, int block) {
  return h > 0 && w > 0 && block > 0 && h % block == 0 && w % block == 0;
}

}  // namespace

extern "C" {

// One fused half-sweep, t1 and t2 updated in place.  elem_bytes 1: int8
// planes, 2: bf16 planes.  block (the caller's tc_block) any positive
// block dividing h and w; every plane 16-byte aligned.  Planes whose
// sides are multiples of 16 take the tiled kernel at its own tile
// (tensorcore_geometry), the others tensorcore_sites_kernel.  Returns a
// cudaError_t (0: launched).
int tensorcore_update_launch(void* t1, void* t2, const void* a,
                             const void* b, int h, int w, int block,
                             int is_black, int elem_bytes,
                             const uint64_t* draw_bounds, uint32_t key,
                             uint32_t offset, void* stream) {
  if (!valid_block(h, w, block) || (elem_bytes != 1 && elem_bytes != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args x = make_args(t1, t2, a, b, h, w, is_black, draw_bounds, key,
                           offset, stream);
  if (!tiled(h, w)) {
    return elem_bytes == 1 ? launch_sites<int8_t>(x)
                           : launch_sites<uint16_t>(x);
  }
  return run(tile_rows(h), tile_cols(w), elem_bytes, x, nullptr);
}

// The tiled kernel's geometry for (h, w) planes of elem_bytes, sides
// multiples of 16: out[0], out[1] its tile rows and columns, out[2] the
// tiles, out[3] the blocks of its persistent grid.  Returns a
// cudaError_t.
int tensorcore_geometry(int h, int w, int elem_bytes, int* out) {
  const int rows = tile_rows(h), cols = tile_cols(w);
  if (h <= 0 || w <= 0 || h % 16 != 0 || w % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  out[0] = rows;
  out[1] = cols;
  out[2] = (h / rows) * (w / cols);
  return run(rows, cols, elem_bytes,
             make_args(nullptr, nullptr, nullptr, nullptr, h, w, 0, nullptr,
                       0u, 0u, nullptr),
             &out[3]);
}

}  // extern "C"
