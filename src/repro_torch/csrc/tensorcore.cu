// Fused tensor-core Metropolis half-sweep on the four sublattice planes,
// for Hopper (sm_90a).
//
// tensorcore_update replaces the Pallas kernel
// src/repro/kernels/tensorcore/tensorcore.py:tensorcore_update (paper
// S3.2, fused).  The lattice is four (h, w) planes '00', '01', '10', '11';
// a half-sweep updates the colour's two target planes t1, t2 (black: 00,
// 11; white: 10, 01) from the other two, a and b (black: 01, 10; white:
// 11, 00).  Within a B x B block the neighbour sums are banded products
// with K = I + superdiagonal:
//
//   black  nn1 = a K + K^T b     nn2 = b K^T + K   a
//   white  nn1 = a K + K   b     nn2 = b K^T + K^T a
//
// plus one value from the adjacent block on the block's edges
// (nn1: a's column left of the block, and b's row above (black) or below
// (white); nn2: b's column right of the block, and a's row below (black)
// or above (white); periodic wrap over the plane).
//
// One block of 8 warps per (block row, block column) of the plane:
//  * a and b are staged in shared memory as bf16 (converted on the way in
//    from int8) with 16-byte coalesced loads, all of a thread's loads
//    issued before its first store, rows swizzled instead of padded; the
//    four edge vectors are read from the neighbour blocks, one row or
//    column each.
//  * The products run on the tensor cores, mma.sync m16n8k16 bf16 -> f32.
//    A warp owns a band of 16 rows and walks its 16 x 8 output tiles of
//    nn1 and nn2.  The spin operand comes from shared memory through
//    ldmatrix (.trans where the spins are the column operand); the K
//    operand is a register fragment made once per thread from
//    K[j][k] = (k == j || k == j + 1) for each offset between the tile
//    and the k-step.  The transposes are the operand layout, never a copy.
//    Only the k-steps whose K tile is not all zero run: 1 or 2 of the
//    B / 16 of each product.
//  * The f32 sums stay in the accumulators (row lane/4 (+8), column
//    2 (lane%4) (+1)); the edge terms, one Philox4x32-10 call per plane
//    position at counter (offset, 0, gi * w + gj, 0) with key (seed mod
//    2^32, 0) -- lane 0 for t1, lane 1 for t2 -- and the accept run there,
//    on the target spins, updated in place (a half-sweep reads only the
//    other colour's planes as neighbours).
//    A spin flips iff u < table[(s > 0) * 5 + (nn + 4) / 2], the 10-entry
//    float32 table of repro_torch.core.metropolis.acceptance_table, for
//    u = float(draw) 2^-32; the kernel tests the same as draw < a 64-bit
//    bound the host derives from each entry (0: never, 2^32: always).
//  * The target spins move between global memory and a small buffer of
//    the warp in whole 16-byte pieces, 2 column tiles (16 bytes of a row
//    of int8) at a time, the next piece loaded while this one is updated:
//    the accumulator layout's 2-byte accesses go to shared memory, never
//    to global memory, where each costs a write transaction of its own.
//
// Bound: bytes.  Per plane position it moves a and b once and t1, t2 in
// and out (6 bytes for int8 planes), against one Philox call (some 18
// multiplies and 24 logic operations) for two sites; the banded products
// are a small load on the tensor pipe.  In practice the kernel is bound
// by instruction issue and latency: Philox and the per-site accept in
// the accumulator layout take most issue slots, and 2 blocks share an SM
// (registers; 71,760 bytes of shared memory each for int8 at B = 128).
// Spins must be +-1: the kernel flips them by their sign bits.
//
// The kernel is a template on the plane type -- int8 (the engine's state)
// and bf16 (the TPU kernel's contract), held as its 16-bit pattern -- and
// on B, a multiple of 16 from 16 to 128.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "philox.cuh"

namespace {

using repro_torch::wrap;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTableSize = 10;

// The accept as exclusive bounds on the raw draw: flip iff bits < v[i],
// which is u < table[i] for u = float(bits) 2^-32 (see
// repro_torch.kernels.tensorcore.tensorcore.draw_bounds).  64 bits hold
// both ends: 0 where no draw flips (the entry underflowed to 0) and 2^32
// where every draw flips.
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
  __device__ static float value(int8_t v) { return static_cast<float>(v); }
  __device__ static bool positive(uint32_t pair, int k) {
    return ((pair >> (8 * k + 7)) & 1u) == 0u;
  }
  // -1 = 0xFF and +1 = 0x01 differ in 0xFE
  __device__ static uint32_t flip_mask(int k) { return 0xFEu << (8 * k); }
};

template <>
struct Spin<uint16_t> {
  using Pair = uint32_t;
  __device__ static float value(uint16_t v) {
    return __uint_as_float(static_cast<uint32_t>(v) << 16);
  }
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
// at d = c0 - k0 from the output tile: thread (g, t) holds rows
// 2t, 2t + 1 (+ 8) of column g.
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

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Shared rows of the spin planes hold B bf16 values in B / 8 chunks of
// 16 bytes, chunk c of row r stored at chunk (c + r) mod (B / 8): rows
// that ldmatrix reads together land in different banks without padding.
template <int B>
__device__ __forceinline__ int swizzled(int r, int chunk) {
  return r * B + ((chunk + r) % (B / 8)) * 8;
}

// The 16 x 16 row-operand fragment of spins at rows r0.., columns k0..
// of a swizzled shared plane.
template <int B>
__device__ __forceinline__ RowFrag spins_row(const uint16_t* x, int r0,
                                             int k0, int lane) {
  RowFrag f;
  const int r = r0 + (lane & 15);
  const uint16_t* p = x + swizzled<B>(r, k0 / 8 + (lane >> 4));
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(f.r[0]), "=r"(f.r[1]), "=r"(f.r[2]), "=r"(f.r[3])
      : "r"(addr)
      : "memory");
  return f;
}

// The 16 x 8 column-operand fragment of spins at rows (k) k0..,
// columns c0.. of a swizzled shared plane: ldmatrix with .trans.
template <int B>
__device__ __forceinline__ ColFrag spins_col(const uint16_t* x, int k0,
                                             int c0, int lane) {
  ColFrag f;
  const uint16_t* p = x + swizzled<B>(k0 + (lane & 15), c0 / 8);
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(f.r[0]), "=r"(f.r[1])
      : "r"(addr)
      : "memory");
  return f;
}

// How a warp walks its targets: kChunk column tiles of 8 at a time, each
// chunk of both target planes' 16 rows moved between global and shared
// memory in whole 16-byte (or, for 8-byte rows, 8-byte) pieces.
template <class T, int B>
struct Walk {
  static constexpr int kBands = B / 16;
  // warps per band: the band's B / 8 column tiles are split over them
  // where there are fewer bands than warps
  static constexpr int kWpb =
      (kWarps / kBands < B / 8) ? kWarps / kBands : B / 8;
  static constexpr int kTiles = (B / 8) / kWpb;  // column tiles per warp
  static constexpr int kChunk = kTiles % 2 == 0 ? 2 : 1;
  static constexpr int kRowBytes = 8 * kChunk * sizeof(T);
  static constexpr int kPiece = kRowBytes % 16 == 0 ? 16 : 8;
  static constexpr int kPieces = 2 * 16 * kRowBytes / kPiece;  // per chunk
  static constexpr int kPerLane = kPieces / 32;
  static constexpr int kBufBytes = 2 * 16 * kRowBytes;          // per warp
  using Piece = typename std::conditional<kPiece == 16, uint4, uint2>::type;
  static_assert((B / 8) % kWpb == 0 && kTiles % kChunk == 0 &&
                    kPieces % 32 == 0,
                "walk");
};

// Dynamic shared memory of one block: a and b as swizzled bf16, each
// warp's target buffer, the four edge vectors and the draw bounds.
template <class T, int B>
__host__ __device__ constexpr size_t smem_bytes() {
  return 2 * sizeof(uint16_t) * B * B +
         static_cast<size_t>(kWarps) * Walk<T, B>::kBufBytes +
         4 * sizeof(float) * B + sizeof(uint64_t) * kTableSize;
}

// The accept of element k of a spin pair: flip iff the draw is below
// bound[(s > 0) * 5 + (nn + 4) / 2].  The index comes from the exact float
// sum without a conversion: 2^23 + 2^22 + 4 (+ 10 for s > 0) + nn has the
// integer nn + 4 (+ 10) in its low mantissa bits.
template <class T>
__device__ __forceinline__ uint32_t accept_mask(uint32_t pair, int k,
                                                float nn, uint32_t draw,
                                                const uint64_t* bound) {
  const bool up = Spin<T>::positive(pair, k);
  const int biased =
      __float_as_int(nn + (up ? 12582926.0f : 12582916.0f)) - 0x4B400000;
  return static_cast<uint64_t>(draw) < bound[biased >> 1]
             ? Spin<T>::flip_mask(k)
             : 0u;
}

// grid (w / B, h / B), kThreads threads; 2 blocks an SM (registers)
template <class T, int B>
__global__ void __launch_bounds__(kThreads, 2)
    tensorcore_update_kernel(T* __restrict__ t1, T* __restrict__ t2,
                             const T* __restrict__ a,
                             const T* __restrict__ b, int h, int w,
                             int is_black, DrawBounds bounds, uint32_t key,
                             uint32_t offset) {
  static_assert(B % 16 == 0 && B >= 16 && B <= 128, "B");
  using W = Walk<T, B>;
  using Piece = typename W::Piece;
  constexpr int kVec = 16 / sizeof(T);           // elements per 16 bytes
  constexpr int kVecs = B * B / kVec;            // 16-byte loads per plane
  constexpr int kLoads = (kVecs + kThreads - 1) / kThreads;

  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* xa = reinterpret_cast<uint16_t*>(smem);
  uint16_t* xb = xa + B * B;
  unsigned char* bufs = reinterpret_cast<unsigned char*>(xb + B * B);
  float* side1 = reinterpret_cast<float*>(bufs + kWarps * W::kBufBytes);
  float* vert1 = side1 + B;
  float* side2 = vert1 + B;
  float* vert2 = side2 + B;
  uint64_t* bound = reinterpret_cast<uint64_t*>(vert2 + B);  // 8-aligned

  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * B;
  const int col0 = blockIdx.x * B;

  // -- stage a and b as bf16, and the edges: every load first ------------
  uint4 va[kLoads], vb[kLoads];
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int v = tid + i * kThreads;
    if (v < kVecs) {
      const size_t at = static_cast<size_t>(row0 + v / (B / kVec)) * w +
                        col0 + (v % (B / kVec)) * kVec;
      va[i] = __ldg(reinterpret_cast<const uint4*>(a + at));
      vb[i] = __ldg(reinterpret_cast<const uint4*>(b + at));
    }
  }
  // nn1 takes a's column left of the block and b's row above (black) /
  // below (white); nn2 b's column right of it and a's row below (black) /
  // above (white)
  float e_side1 = 0.f, e_vert1 = 0.f, e_side2 = 0.f, e_vert2 = 0.f;
  if (tid < B) {
    const int above = wrap(row0 - 1, h);
    const int below = wrap(row0 + B, h);
    const size_t row = static_cast<size_t>(row0 + tid) * w;
    e_side1 = Spin<T>::value(__ldg(a + row + wrap(col0 - 1, w)));
    e_side2 = Spin<T>::value(__ldg(b + row + wrap(col0 + B, w)));
    e_vert1 = Spin<T>::value(__ldg(
        b + static_cast<size_t>(is_black ? above : below) * w + col0 + tid));
    e_vert2 = Spin<T>::value(__ldg(
        a + static_cast<size_t>(is_black ? below : above) * w + col0 + tid));
  }
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int v = tid + i * kThreads;
    if (v < kVecs) {
      const int r = v / (B / kVec);
      const int chunk = (v % (B / kVec)) * kVec / 8;
      if constexpr (sizeof(T) == 2) {
        *reinterpret_cast<uint4*>(xa + swizzled<B>(r, chunk)) = va[i];
        *reinterpret_cast<uint4*>(xb + swizzled<B>(r, chunk)) = vb[i];
      } else {
        const uint32_t wa[4] = {va[i].x, va[i].y, va[i].z, va[i].w};
        const uint32_t wb[4] = {vb[i].x, vb[i].y, vb[i].z, vb[i].w};
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int at = swizzled<B>(r, chunk + half);
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
  if (tid < B) {
    side1[tid] = e_side1;
    vert1[tid] = e_vert1;
    side2[tid] = e_side2;
    vert2[tid] = e_vert2;
  }
  if (tid < kTableSize) bound[tid] = bounds.v[tid];
  __syncthreads();

  const int warp = tid / 32;
  if (warp >= W::kBands * W::kWpb) return;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = (warp / W::kWpb) * 16;
  const int first_tile = (warp % W::kWpb) * W::kTiles;
  unsigned char* buf = bufs + warp * W::kBufBytes;

  // K fragments of this thread, one per offset between tile and k-step.
  // Column operand: x K at d = c0 - k0 in {0, 8, 16}; x K^T at d in
  // {0, 8, -8}.  Row operand: nn1 takes K^T b (black) / K b (white), nn2
  // K a (black) / K^T a (white), each at k0 = r0 and at the other band
  // they reach: r0 - 16 for K^T, r0 + 16 for K.
  const ColFrag k_at0 = col_k(0, g, t), k_at8 = col_k(8, g, t),
                k_prev = col_k(16, g, t);
  const ColFrag kt_at0 = col_kt(0, g, t), kt_at8 = col_kt(8, g, t),
                kt_next = col_kt(-8, g, t);
  const bool kt1 = is_black != 0;          // nn1's row operand is K^T
  const int d1 = kt1 ? -16 : 16;           // its second k-step
  const int d2 = -d1;                      // nn2's (K^T iff !kt1)
  const RowFrag l1 = row_k(kt1, 0, g, t), l1x = row_k(kt1, d1, g, t);
  const RowFrag l2 = row_k(!kt1, 0, g, t), l2x = row_k(!kt1, d2, g, t);
  const bool has1x = r0 + d1 >= 0 && r0 + d1 < B;
  const bool has2x = r0 + d2 >= 0 && r0 + d2 < B;

  // the targets of a chunk: piece i of the lane is plane i / (16 pieces
  // per row group), row, piece within the row
  constexpr int kRowPieces = W::kRowBytes / W::kPiece;
  auto piece_at = [&](int i, int first, size_t* global, int* local) {
    const int u = lane + 32 * i;
    const int plane = u / (16 * kRowPieces);
    const int row = (u / kRowPieces) % 16;
    const int part = u % kRowPieces;
    *global = static_cast<size_t>(row0 + r0 + row) * w + col0 + first * 8 +
              part * (W::kPiece / static_cast<int>(sizeof(T)));
    *local = (plane * 16 + row) * W::kRowBytes + part * W::kPiece;
    return plane;
  };
  Piece ahead[W::kPerLane];
  auto fetch = [&](int first) {
#pragma unroll
    for (int i = 0; i < W::kPerLane; ++i) {
      size_t at;
      int local;
      const int plane = piece_at(i, first, &at, &local);
      ahead[i] = *reinterpret_cast<const Piece*>(plane ? t2 + at : t1 + at);
    }
  };
  fetch(first_tile);
  for (int first = first_tile; first < first_tile + W::kTiles;
       first += W::kChunk) {
#pragma unroll
    for (int i = 0; i < W::kPerLane; ++i) {
      size_t at;
      int local;
      piece_at(i, first, &at, &local);
      *reinterpret_cast<Piece*>(buf + local) = ahead[i];
    }
    __syncwarp();
    if (first + W::kChunk < first_tile + W::kTiles) fetch(first + W::kChunk);

#pragma unroll
    for (int tile = 0; tile < W::kChunk; ++tile) {
      const int c0 = (first + tile) * 8;
      float nn1[4] = {0.f, 0.f, 0.f, 0.f};
      float nn2[4] = {0.f, 0.f, 0.f, 0.f};
      const int kc = c0 & ~15;
      const bool odd = (c0 & 8) != 0;
      {  // nn1 = a K + (K^T | K) b
        RowFrag x = spins_row<B>(xa, r0, kc, lane);
        mma_bf16(nn1, x.r, (odd ? k_at8 : k_at0).r);
        if (!odd && c0 > 0) {
          x = spins_row<B>(xa, r0, kc - 16, lane);
          mma_bf16(nn1, x.r, k_prev.r);
        }
        ColFrag y = spins_col<B>(xb, r0, c0, lane);
        mma_bf16(nn1, l1.r, y.r);
        if (has1x) {
          y = spins_col<B>(xb, r0 + d1, c0, lane);
          mma_bf16(nn1, l1x.r, y.r);
        }
      }
      {  // nn2 = b K^T + (K | K^T) a
        RowFrag x = spins_row<B>(xb, r0, kc, lane);
        mma_bf16(nn2, x.r, (odd ? kt_at8 : kt_at0).r);
        if (odd && c0 + 8 < B) {
          x = spins_row<B>(xb, r0, kc + 16, lane);
          mma_bf16(nn2, x.r, kt_next.r);
        }
        ColFrag y = spins_col<B>(xa, r0, c0, lane);
        mma_bf16(nn2, l2.r, y.r);
        if (has2x) {
          y = spins_col<B>(xa, r0 + d2, c0, lane);
          mma_bf16(nn2, l2x.r, y.r);
        }
      }
      // this thread's targets in the buffer: rows g, g + 8, columns
      // 2t, 2t + 1 of the tile
      using Pair = typename Spin<T>::Pair;
      unsigned char* at1 =
          buf + g * W::kRowBytes + (tile * 8 + 2 * t) * sizeof(T);
      unsigned char* at2 = at1 + 16 * W::kRowBytes;
      uint32_t s1[2], s2[2], f1[2] = {0u, 0u}, f2[2] = {0u, 0u};
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        s1[hr] = *reinterpret_cast<const Pair*>(at1 + 8 * hr * W::kRowBytes);
        s2[hr] = *reinterpret_cast<const Pair*>(at2 + 8 * hr * W::kRowBytes);
      }
      // edge terms: element e is row r0 + g (+ 8 for e >= 2), column
      // c0 + 2t (+ 1 for odd e); the tests on c0 and r0 are the warp's
      if (c0 == 0 && t == 0) {                  // column 0: nn1
        nn1[0] += side1[r0 + g];
        nn1[2] += side1[r0 + g + 8];
      }
      if (c0 == B - 8 && t == 3) {              // column B - 1: nn2
        nn2[1] += side2[r0 + g];
        nn2[3] += side2[r0 + g + 8];
      }
      // nn1's edge row: the block's first row (black, elements 0 and 1
      // of g = 0 in band 0) or its last (white, elements 2 and 3 of g = 7
      // in the last band); nn2's the other
      if (r0 == (is_black ? 0 : B - 16) && g == (is_black ? 0 : 7)) {
        const float v0 = vert1[c0 + 2 * t], v1 = vert1[c0 + 2 * t + 1];
        if (is_black) {
          nn1[0] += v0;
          nn1[1] += v1;
        } else {
          nn1[2] += v0;
          nn1[3] += v1;
        }
      }
      if (r0 == (is_black ? B - 16 : 0) && g == (is_black ? 7 : 0)) {
        const float v0 = vert2[c0 + 2 * t], v1 = vert2[c0 + 2 * t + 1];
        if (is_black) {
          nn2[2] += v0;
          nn2[3] += v1;
        } else {
          nn2[0] += v0;
          nn2[1] += v1;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + g + (e >= 2 ? 8 : 0);
        const int c = c0 + 2 * t + (e & 1);
        const uint32_t gidx =
            static_cast<uint32_t>(row0 + r) * static_cast<uint32_t>(w) +
            static_cast<uint32_t>(col0 + c);
        const uint4 draw = repro_torch::philox4x32_10(
            make_uint4(offset, 0u, gidx, 0u), key, 0u);
        const int hr = e >> 1, k = e & 1;
        f1[hr] |= accept_mask<T>(s1[hr], k, nn1[e], draw.x, bound);
        f2[hr] |= accept_mask<T>(s2[hr], k, nn2[e], draw.y, bound);
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        *reinterpret_cast<Pair*>(at1 + 8 * hr * W::kRowBytes) =
            static_cast<Pair>(s1[hr] ^ f1[hr]);
        *reinterpret_cast<Pair*>(at2 + 8 * hr * W::kRowBytes) =
            static_cast<Pair>(s2[hr] ^ f2[hr]);
      }
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < W::kPerLane; ++i) {
      size_t at;
      int local;
      const int plane = piece_at(i, first, &at, &local);
      *reinterpret_cast<Piece*>(plane ? t2 + at : t1 + at) =
          *reinterpret_cast<const Piece*>(buf + local);
    }
    __syncwarp();
  }
}

template <class T, int B>
int launch(void* t1, void* t2, const void* a, const void* b, int h, int w,
           int is_black, const DrawBounds& bounds, uint32_t key,
           uint32_t offset, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, B>();
  cudaError_t err = cudaFuncSetAttribute(
      tensorcore_update_kernel<T, B>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(w / B, h / B);
  tensorcore_update_kernel<T, B><<<grid, kThreads, smem, stream>>>(
      static_cast<T*>(t1), static_cast<T*>(t2), static_cast<const T*>(a),
      static_cast<const T*>(b), h, w, is_black, bounds, key, offset);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_block(void* t1, void* t2, const void* a, const void* b, int h,
                 int w, int block, int is_black, const DrawBounds& bounds,
                 uint32_t key, uint32_t offset, cudaStream_t stream) {
#define REPRO_TC_BLOCK(B)                                                \
  case B:                                                                \
    return launch<T, B>(t1, t2, a, b, h, w, is_black, bounds, key, offset, \
                        stream);
  switch (block) {
    REPRO_TC_BLOCK(16)
    REPRO_TC_BLOCK(32)
    REPRO_TC_BLOCK(48)
    REPRO_TC_BLOCK(64)
    REPRO_TC_BLOCK(80)
    REPRO_TC_BLOCK(96)
    REPRO_TC_BLOCK(112)
    REPRO_TC_BLOCK(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_TC_BLOCK
}

}  // namespace

extern "C" {

// One fused half-sweep, t1 and t2 updated in place.  elem_bytes 1: int8
// planes, 2: bf16 planes.  block a multiple of 16 in [16, 128] dividing h
// and w; every plane 16-byte aligned.  Returns a cudaError_t (0: launched).
int tensorcore_update_launch(void* t1, void* t2, const void* a,
                             const void* b, int h, int w, int block,
                             int is_black, int elem_bytes,
                             const uint64_t* draw_bounds, uint32_t key,
                             uint32_t offset, void* stream) {
  if (block <= 0 || h % block != 0 || w % block != 0 ||
      (elem_bytes != 1 && elem_bytes != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DrawBounds bounds;
  for (int i = 0; i < kTableSize; ++i) bounds.v[i] = draw_bounds[i];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 1) {
    return launch_block<int8_t>(t1, t2, a, b, h, w, block, is_black, bounds,
                                key, offset, st);
  }
  return launch_block<uint16_t>(t1, t2, a, b, h, w, block, is_black, bounds,
                                key, offset, st);
}

}  // extern "C"
