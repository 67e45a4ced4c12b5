// Multi-spin coded Metropolis (8 spins per uint32 word), for Hopper
// (sm_90a).
//
// Three kernels with a plain C interface (loaded with ctypes by
// repro_torch.kernels.multispin and repro_torch.dist.kernels):
//
// * multispin_update: one colour half-sweep of a word plane.  Replaces
//   the Pallas kernel src/repro/kernels/multispin/multispin.py:
//   multispin_update.  One thread per target word: it reads its target
//   word and the op words at (r, c), (r +- 1, c), and (r, c +- 1) for the
//   nibble funnel shift of the side word (the direction follows the
//   global row parity and the colour), forms the 8 neighbour sums with 3
//   packed adds, draws two Philox4x32-10 blocks at counters
//   (2*off, 0, widx, 0) and (2*off + 1, 0, widx, 0) with
//   widx = r * W + c, and flips nibble n iff draw n < t[s * 5 + nn].
//   Each thread reads only its own target word, so the update is in
//   place.  The Pallas kernel keys Philox on (seed mod 2^32, 0); this one
//   keys on both lanes of the 64-bit seed, as the JAX package's oracle
//   and resident kernel do.
//   Bound: the two Philox calls per word (integer multiplies and XORs),
//   not its 12 bytes; threads stay independent so that every warp can
//   issue integer work.
//
// * multispin_sweeps_resident: n_sweeps full sweeps in one launch.
//   Replaces src/repro/kernels/multispin/resident.py:
//   multispin_sweeps_resident, which holds both word planes in TPU VMEM.
//   A block has at most 227 KB of shared memory, so this kernel blocks
//   in time on tiles of words: a tile of both planes plus a halo of at
//   least 2 * n_sweeps word rows and word columns (the side tap reaches
//   one word over per half-sweep), 2 * n_sweeps half-sweeps with a
//   barrier between them, and a write-back of the tile only.  Half-sweep
//   q updates the words at distance >= q + 1 from the extended tile's
//   edge, which are exact, and draws are keyed on the global word index,
//   so the tile is bit for bit what whole-plane sweeps give.  Input and
//   output planes must differ.
//
// * multispin_shard_sweeps: n_sweeps full sweeps of one halo-extended
//   word shard of a sharded run.  Replaces src/repro/dist/kernels.py:
//   multispin_shard_sweeps, which updates the whole extended shard in
//   TPU VMEM with wrap taps, keying each word's two draws on a plane of
//   uint32 global word indices (widx) and taking the row parity from the
//   extended plane's own row index.  Here the temporal blocking above
//   runs on the extended plane as if it were a lattice (tiles wrap over
//   its own dims), keyed on widx, whose extended tile each block stages
//   in shared memory beside the planes (12 bytes a word), so any widx
//   plane is drawn exactly.  The result equals the TPU kernel's on the
//   whole extended plane, its edge rings included.  Input and output
//   planes must differ.
//
//   Both run one word loop (multispin_sweeps_kernel<kShard>, and its
//   member axis multispin_sweeps_members_kernel).  Bound:
//   instruction issue, not bytes (a word moves 8 bytes a launch but needs
//   two Philox calls and 8 compares, some 140 instructions).  On an H100
//   the integer costs add rather than overlap: the paired Philox alone
//   takes 1.23 SM clocks a word, with this accept 1.81
//   (repro_torch.analysis.issue_rate), as if each wide multiply took an
//   ALU-pipe slot besides its two FMA-pipe slots.  So the design cuts
//   instructions: the two calls of a word drawn as one HoistedPhiloxPair
//   (philox_lane0.cuh: what depends on the offset made once a
//   half-sweep, the key schedule made on the host and read as uniform
//   operands, rounds 0 and 1's site products shared by the calls: 34
//   wide multiplies and 37 XORs a word, where two philox4x32_10 calls
//   take 40 wide multiplies); the accept one key word of nibbles
//   s * 8 + c, one 8-byte table load of two nibbles' thresholds a key
//   byte (its offset a byte permute) and a predicated OR a nibble: 130
//   instructions a word in the k-sweep kernel's loop, 136 in the shard
//   kernel's, where a 4-byte load, a select and an add a nibble took 142
//   and 143; no division and no index load in any loop (rows and
//   columns from the loop counters, the word index a row base plus the
//   column, the wrap by subtraction, the lattice-edge tiles' column wrap
//   in a loop of its own); a warp a row and a lane a word; the region one
//   ring smaller each half-sweep and cut to the plane at a ragged edge;
//   tiles loaded and stored 16 bytes at a time where they lie inside the
//   plane and line up, word by word elsewhere.  Measured no faster, and
//   not kept (PERF.md): cp.async staging, a persistent grid staging the
//   next tile while it sweeps this one, draws one word ahead, two words
//   a pass, the two calls one after the other, per-row pointers, more
//   blocks an SM at fewer registers.  The neighbour loads cost 2 % (the
//   kernel without them, repro_torch.analysis.ablate), so the up and
//   centre words are not kept in registers down a column.  No tensor
//   cores, TMA or wgmma: the work is integer issue.
//
// Ensembles (common.cuh): multispin_update and multispin_sweeps_resident
// also run B members' stacked word planes in one launch, blockIdx.z the
// member, each member's thresholds (or key table) and Philox keys one
// record of a __grid_constant__ parameter (multispin_update's kBatch
// instance, and multispin_sweeps_members_kernel beside the k-sweep
// kernel of one member; the shard kernel runs one member): what jax.vmap
// makes of the two pallas_calls under repro.api.session._EnsembleRunner.
//
// multispin_update's accept compares the raw uint32 draw with 10 uint32
// thresholds passed by value (repro_torch.core.multispin.
// acceptance_thresholds); the k-sweep kernels take the same thresholds
// as a 16-entry table indexed by s * 8 + c.  No float, no exp.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "common.cuh"
#include "philox.cuh"
#include "philox_lane0.cuh"

namespace {

using repro_torch::aligned;
using repro_torch::ext_cols;
using repro_torch::kClasses;
using repro_torch::left_halo;
using repro_torch::make_thresholds;
using repro_torch::Thresholds;
using repro_torch::wrap_near;

constexpr int kNibble = 4;

__device__ __forceinline__ void load_thresholds(const Thresholds& thr,
                                                uint32_t* s_thr, int tid) {
  if (tid < kClasses) s_thr[tid] = thr.v[tid];
}

// The side word: toward k+1, nibble n takes nibble n+1 and the next
// word's nibble 0 enters at the top; toward k-1 the reverse.
__device__ __forceinline__ uint32_t side_word(uint32_t center,
                                              uint32_t neighbor, bool plus) {
  return plus ? (center >> kNibble) | (neighbor << (32 - kNibble))
              : (center << kNibble) | (neighbor >> (32 - kNibble));
}

// The new target word: 8 draws from two Philox blocks, one compare per
// nibble against the threshold of its (spin, neighbour count) class.
__device__ __forceinline__ uint32_t update_word(uint32_t target, uint32_t nn,
                                                uint32_t widx,
                                                uint32_t offset, uint32_t k0,
                                                uint32_t k1,
                                                const uint32_t* thr) {
  const uint32_t c0 = 2u * offset;  // wraps modulo 2^32
  const uint4 lo =
      repro_torch::philox4x32_10(make_uint4(c0, 0u, widx, 0u), k0, k1);
  const uint4 hi =
      repro_torch::philox4x32_10(make_uint4(c0 + 1u, 0u, widx, 0u), k0, k1);
  const uint32_t draws[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  uint32_t flip = 0;
#pragma unroll
  for (int nib = 0; nib < 8; ++nib) {
    const int sh = kNibble * nib;
    const uint32_t s = (target >> sh) & 1u;
    const uint32_t c = (nn >> sh) & 0xFu;
    flip |= static_cast<uint32_t>(draws[nib] < thr[s * 5u + c]) << sh;
  }
  return target ^ flip;
}

// A member's record of multispin_update: its thresholds and key.
struct UpdateMember {
  Thresholds thr;
  uint32_t k0, k1;
};

// grid (n, ceil(w / blockDim.x), members): blockIdx.x is the row
template <bool kBatch>
__global__ void multispin_update_kernel(
    uint32_t* __restrict__ target, const uint32_t* __restrict__ op, int n,
    int w, int is_black,
    const __grid_constant__ repro_torch::Members<UpdateMember, kBatch> members,
    uint32_t offset) {
  const int member = repro_torch::member_index<kBatch>();
  const Thresholds& thr = members.v[member].thr;
  const uint32_t k0 = members.v[member].k0;
  const uint32_t k1 = members.v[member].k1;
  target += repro_torch::member_offset(member, n, w);
  op += repro_torch::member_offset(member, n, w);
  __shared__ uint32_t s_thr[kClasses];
  load_thresholds(thr, s_thr, threadIdx.x);
  __syncthreads();
  const int row = blockIdx.x;
  const int col = blockIdx.y * blockDim.x + threadIdx.x;
  if (col >= w) return;
  const int up = row == 0 ? n - 1 : row - 1;
  const int down = row == n - 1 ? 0 : row + 1;
  // black targets take k+1 on odd rows, k-1 on even; white the reverse
  const bool plus = ((row & 1) != 0) == (is_black != 0);
  const int side = plus ? (col == w - 1 ? 0 : col + 1)
                        : (col == 0 ? w - 1 : col - 1);
  const size_t base = static_cast<size_t>(row) * w;
  const uint32_t center = op[base + col];
  const uint32_t nn = op[static_cast<size_t>(up) * w + col] +
                      op[static_cast<size_t>(down) * w + col] + center +
                      side_word(center, op[base + side], plus);
  const uint32_t widx =
      static_cast<uint32_t>(row) * static_cast<uint32_t>(w) +
      static_cast<uint32_t>(col);
  target[base + col] =
      update_word(target[base + col], nn, widx, offset, k0, k1, s_thr);
}

// -- the k-sweep and shard kernels: one word loop ---------------------------
//
// An extended tile of both word planes sits in shared memory: tile_r + 4k
// rows (a halo of 2k above and below) of ext_cols() words (a halo of
// left_halo() words on each side: 2k rounded up to 4, so that a tile's
// words line up with the plane's 16-byte chunks), at the most; a tile at
// a ragged edge of the plane fills fewer rows and words of it.  Rows go
// to warps; a lane takes one word, the lanes of a warp consecutive words.
// A word's up, down and centre words in the opposite plane are read whole
// and its side word is a funnel shift of the centre and the word beside
// it, toward +1 or -1 by the row's parity (a template argument of the row
// loop).  The 8 up-neighbour counts (0..4 a nibble) and the 8 spins make
// one key word of nibbles s * 8 + c, and 8 x each key byte is the byte
// offset of its two nibbles' thresholds in a table of 256 pairs at the
// start of shared memory: one 8-byte load for two nibbles.  A nibble
// flips iff its draw is below its threshold.

// Entries of the k-sweep and shard kernels' threshold table: entry
// s * 8 + c is t[s * 5 + c] (repro_torch.kernels._words.key_table);
// entries 5-7 and 13-15 are never read.  A block expands it in shared
// memory to the 256 threshold pairs of a key byte (the entries of its
// low and its high nibble, 8 bytes at 8 x the byte).
constexpr int kKeyClasses = 16;
constexpr int kTableBytes = 8 * 256;

struct KeyTable {
  uint32_t v[kKeyClasses];
};

// A member's record of the k-sweep and shard kernels: its table and key
// schedule
struct SweepMember {
  KeyTable table;
  repro_torch::PhiloxKeys keys;
};

// Shared memory of one k-sweep block: the table, then both extended
// planes.
__host__ __device__ inline size_t resident_smem_bytes(int tile_r, int tile_c,
                                                      int n_sweeps) {
  const size_t er = tile_r + 4 * n_sweeps;
  return kTableBytes + 2 * 4 * er * ext_cols(tile_c, n_sweeps);
}

// Shared memory of one shard block: the table, the extended tile's word
// indices, then both extended planes.
__host__ __device__ inline size_t shard_smem_bytes(int tile_r, int tile_c,
                                                   int n_sweeps) {
  const size_t er = tile_r + 4 * n_sweeps;
  return kTableBytes + 3 * 4 * er * ext_cols(tile_c, n_sweeps);
}

// Where a block's extended tile sits: rows r0.., words c0.. of an n x w
// plane (both may lie off the plane and wrap); er rows of ew words hold
// the tile and its halo, rows pitch words apart in shared memory.
struct Tile {
  int n, w, r0, c0, er, ew, pitch;
};

// flip |= bit where draw < threshold: a predicated OR, 5 % faster on an
// H100 than the select and add the compiler makes of the C compare
// (python -m repro_torch.analysis.ablate multispin)
__device__ __forceinline__ void flip_below(uint32_t& flip, uint32_t draw,
                                           uint32_t threshold, uint32_t bit) {
  asm("{\n"
      "  .reg .pred p;\n"
      "  setp.lt.u32 p, %1, %2;\n"
      "  @p or.b32 %0, %0, %3;\n"
      "}"
      : "+r"(flip)
      : "r"(draw), "r"(threshold), "r"(bit));
}

// The new target word t at shared word c of a row whose side neighbour
// is at word +1 (kPlus) or -1; widx keys its draws.
template <bool kPlus>
__device__ __forceinline__ uint32_t sweep_word(
    uint32_t t, const uint32_t* __restrict__ op, int c, int pitch,
    uint32_t widx, const repro_torch::HoistedPhiloxPair& philox,
    const unsigned char* s_table) {
  const uint32_t centre = op[c];
  const uint32_t side = kPlus
                            ? __funnelshift_r(centre, op[c + 1], kNibble)
                            : __funnelshift_l(op[c - 1], centre, kNibble);
  // per nibble: s * 8 + the count of up neighbours
  const uint32_t key = (op[c - pitch] + op[c + pitch] + centre + side) |
                       ((t & 0x11111111u) << 3);
  // per 16-bit half: 8 x key bytes 0 and 2, and 8 x key bytes 1 and 3,
  // the byte offsets of their threshold pairs
  const uint32_t even = (key & 0x00FF00FFu) << 3;
  const uint32_t odd = (key >> 5) & 0x07F807F8u;
  uint32_t draw[8];
  philox(widx, draw);
  uint32_t flip = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const uint32_t at =
        __byte_perm(b & 1 ? odd : even, 0u, b >> 1 ? 0x4432u : 0x4410u);
    const uint2 thr = *reinterpret_cast<const uint2*>(s_table + at);
    flip_below(flip, draw[2 * b], thr.x, 1u << (2 * kNibble * b));
    flip_below(flip, draw[2 * b + 1], thr.y, 1u << (2 * kNibble * b + 4));
  }
  return t ^ flip;
}

// One row of half-sweep words: words [w_lo, w_hi) of extended row i
// (global or extended-plane row gr), the lanes of a warp on consecutive
// words.  kWrap: a k-sweep tile at the lattice's edge, whose columns
// wrap (each loop stays free of the other path's branches).
template <bool kShard, bool kPlus, bool kWrap>
__device__ __forceinline__ void sweep_row(
    uint32_t* __restrict__ tgt, const uint32_t* __restrict__ op,
    const uint32_t* __restrict__ s_g, const Tile& tile, int i, int gr,
    int w_lo, int w_hi, const repro_torch::HoistedPhiloxPair& philox,
    const unsigned char* s_table) {
  const int row = i * tile.pitch;
  const uint32_t row_base =
      static_cast<uint32_t>(gr) * static_cast<uint32_t>(tile.w);
#pragma unroll 1
  for (int wc = w_lo + (threadIdx.x & 31); wc < w_hi; wc += 32) {
    const int c = row + wc;
    uint32_t widx;
    if (kShard) {
      widx = s_g[c];
    } else if (!kWrap) {
      widx = row_base + static_cast<uint32_t>(tile.c0 + wc);
    } else {
      widx = row_base + static_cast<uint32_t>(wrap_near(tile.c0 + wc, tile.w));
    }
    tgt[c] = sweep_word<kPlus>(tgt[c], op, c, tile.pitch, widx, philox,
                               s_table);
  }
}

// Half-sweep q of colour `color`: the words at distance >= m = q + 1 from
// the extended tile's edge.  Row parity from the wrapped row: the
// lattice's (k-sweep) or the extended plane's own (shard).
template <bool kShard, bool kWrap>
__device__ __forceinline__ void half_sweep(
    uint32_t* __restrict__ tgt, const uint32_t* __restrict__ op,
    const uint32_t* __restrict__ s_g, const Tile& tile, int m, int color,
    const repro_torch::HoistedPhiloxPair& philox,
    const unsigned char* s_table) {
  const int nwarps = blockDim.x >> 5;
  for (int i = m + (threadIdx.x >> 5); i < tile.er - m; i += nwarps) {
    const int gr = wrap_near(tile.r0 + i, tile.n);
    // black targets take k+1 on odd rows, k-1 on even; white the reverse
    if (((gr & 1) != 0) == (color == 0)) {
      sweep_row<kShard, true, kWrap>(tgt, op, s_g, tile, i, gr, m,
                                     tile.ew - m, philox, s_table);
    } else {
      sweep_row<kShard, false, kWrap>(tgt, op, s_g, tile, i, gr, m,
                                      tile.ew - m, philox, s_table);
    }
  }
}

// Stage the extended tile of both planes (and, for a shard, of widx):
// 16 bytes at a time where the tile's words lie in the plane and line
// up, else word by word with wrapped columns.
template <bool kShard>
__device__ __forceinline__ void load_tile(
    const uint32_t* __restrict__ b_in, const uint32_t* __restrict__ w_in,
    const uint32_t* __restrict__ widx, uint32_t* s_b, uint32_t* s_w,
    uint32_t* s_g, const Tile& tile, bool vec) {
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int i = threadIdx.x >> 5; i < tile.er; i += nwarps) {
    const size_t g =
        static_cast<size_t>(wrap_near(tile.r0 + i, tile.n)) * tile.w;
    const int s = i * tile.pitch;
    if (vec) {
      const size_t at = g + tile.c0;
      for (int q = lane; q < (tile.ew >> 2); q += 32) {
        reinterpret_cast<uint4*>(s_b + s)[q] =
            reinterpret_cast<const uint4*>(b_in + at)[q];
        reinterpret_cast<uint4*>(s_w + s)[q] =
            reinterpret_cast<const uint4*>(w_in + at)[q];
        if (kShard) {
          reinterpret_cast<uint4*>(s_g + s)[q] =
              reinterpret_cast<const uint4*>(widx + at)[q];
        }
      }
    } else {
      int gc = wrap_near(tile.c0 + lane, tile.w);
      for (int j = lane; j < tile.ew; j += 32) {
        s_b[s + j] = b_in[g + gc];
        s_w[s + j] = w_in[g + gc];
        if (kShard) s_g[s + j] = widx[g + gc];
        gc = wrap_near(gc + 32, tile.w);
      }
    }
  }
}

// n_sweeps sweeps of one extended tile; the k-sweep kernel (kShard
// false) keys each word's draws on the lattice word row * w + col, the
// shard kernel on the word index staged from widx.  grid (ceil(w /
// tile_c), ceil(n / tile_r)), 1-D blocks of whole warps, at most 512.
// `words`: w and tile_c are multiples of 4 and every plane pointer is
// 16-byte aligned.
template <bool kShard>
__device__ __forceinline__ void sweep_tile(
    const uint32_t* __restrict__ b_in, const uint32_t* __restrict__ w_in,
    const uint32_t* __restrict__ widx, uint32_t* __restrict__ b_out,
    uint32_t* __restrict__ w_out, int n, int w, const KeyTable& table,
    const repro_torch::PhiloxKeys& keys, uint32_t start, int n_sweeps,
    int tile_r, int tile_c, int words) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int halo = 2 * n_sweeps;
  const int hl = left_halo(n_sweeps);
  const int by = static_cast<int>(blockIdx.y);
  const int bx = static_cast<int>(blockIdx.x);
  const int rows = min(tile_r, n - by * tile_r);
  const int cols = min(tile_c, w - bx * tile_c);
  Tile tile;
  tile.n = n;
  tile.w = w;
  tile.r0 = by * tile_r - halo;
  tile.c0 = bx * tile_c - hl;
  tile.er = rows + 2 * halo;
  tile.ew = ext_cols(cols, n_sweeps);
  tile.pitch = ext_cols(tile_c, n_sweeps);
  const size_t plane_words =
      static_cast<size_t>(tile_r + 2 * halo) * tile.pitch;
  uint32_t* s_g = reinterpret_cast<uint32_t*>(smem + kTableBytes);
  uint32_t* s_b = s_g + (kShard ? plane_words : 0);
  uint32_t* s_w = s_b + plane_words;
  // the pair of each key byte; constant indices into the table, which
  // so stays in the parameter space
  for (int pair = threadIdx.x; pair < 256; pair += blockDim.x) {
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int e = 0; e < kKeyClasses; ++e) {
      if ((pair & 15) == e) lo = table.v[e];
      if ((pair >> 4) == e) hi = table.v[e];
    }
    reinterpret_cast<uint2*>(smem)[pair] = make_uint2(lo, hi);
  }
  const bool inside = tile.c0 >= 0 && tile.c0 + tile.ew <= w;
  load_tile<kShard>(b_in, w_in, widx, s_b, s_w, s_g, tile, words && inside);
  __syncthreads();

  for (int s = 0; s < n_sweeps; ++s) {
    for (int color = 0; color < 2; ++color) {
      // half_sweep_offset(start, s, color), uint32 wrap; its two Philox
      // counters are 2 offset and 2 offset + 1
      const uint32_t offset = start + 2u * static_cast<uint32_t>(s) +
                              static_cast<uint32_t>(color);
      const repro_torch::HoistedPhiloxPair philox(2u * offset, keys);
      uint32_t* tgt = color ? s_w : s_b;
      const uint32_t* op = color ? s_b : s_w;
      const int m = 2 * s + color + 1;
      if (kShard || inside) {
        half_sweep<kShard, false>(tgt, op, s_g, tile, m, color, philox, smem);
      } else {
        half_sweep<kShard, true>(tgt, op, s_g, tile, m, color, philox, smem);
      }
      __syncthreads();
    }
  }

  // the tile's words
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int i = threadIdx.x >> 5; i < rows; i += nwarps) {
    const size_t g = static_cast<size_t>(by * tile_r + i) * w +
                     static_cast<size_t>(bx) * tile_c;
    const int li = (i + halo) * tile.pitch + hl;
    if (words) {
      for (int q = lane; q < (cols >> 2); q += 32) {
        reinterpret_cast<uint4*>(b_out + g)[q] =
            reinterpret_cast<const uint4*>(s_b + li)[q];
        reinterpret_cast<uint4*>(w_out + g)[q] =
            reinterpret_cast<const uint4*>(s_w + li)[q];
      }
    } else {
      for (int j = lane; j < cols; j += 32) {
        b_out[g + j] = s_b[li + j];
        w_out[g + j] = s_w[li + j];
      }
    }
  }
}

// One member's tile: its table and key schedule by value (the constant
// bank's operands in the word loop, as before the member axis came:
// binding them from a __grid_constant__ record of one member cost the
// loop 4 IMADs a word).
template <bool kShard>
__global__ void __launch_bounds__(512) multispin_sweeps_kernel(
    const uint32_t* __restrict__ b_in, const uint32_t* __restrict__ w_in,
    const uint32_t* __restrict__ widx, uint32_t* __restrict__ b_out,
    uint32_t* __restrict__ w_out, int n, int w, KeyTable table,
    repro_torch::PhiloxKeys keys, uint32_t start, int n_sweeps, int tile_r,
    int tile_c, int words) {
  sweep_tile<kShard>(b_in, w_in, widx, b_out, w_out, n, w, table, keys,
                     start, n_sweeps, tile_r, tile_c, words);
}

// The member axis of the k-sweep kernel: grid (ceil(w / tile_c), ceil(n /
// tile_r), members), member blockIdx.z on the planes at its offset with
// its record.
__global__ void __launch_bounds__(512) multispin_sweeps_members_kernel(
    const uint32_t* __restrict__ b_in, const uint32_t* __restrict__ w_in,
    uint32_t* __restrict__ b_out, uint32_t* __restrict__ w_out, int n, int w,
    const __grid_constant__ repro_torch::Members<SweepMember, true> members,
    uint32_t start, int n_sweeps, int tile_r, int tile_c, int words) {
  const int member = static_cast<int>(blockIdx.z);
  const size_t plane = repro_torch::member_offset(member, n, w);
  sweep_tile<false>(b_in + plane, w_in + plane, nullptr, b_out + plane,
                    w_out + plane, n, w, members.v[member].table,
                    members.v[member].keys, start, n_sweeps, tile_r, tile_c,
                    words);
}

// The records of `members` members from their tables (16 entries each)
// and key pairs (k0, k1 each).
repro_torch::Members<SweepMember, true> make_members(const uint32_t* table,
                                                     const uint32_t* keys,
                                                     int members) {
  repro_torch::Members<SweepMember, true> out;
  for (int i = 0; i < members; ++i) {
    std::memcpy(out.v[i].table.v, table + kKeyClasses * i,
                sizeof(out.v[i].table.v));
    out.v[i].keys = repro_torch::PhiloxKeys(keys[2 * i], keys[2 * i + 1]);
  }
  return out;
}

// Launch one of the three (the shard kernel, the k-sweep kernel of one
// member or of `members`); returns the CUDA error (0: launched).
int launch_sweeps(bool shard, const void* b_in, const void* w_in,
                  const void* widx, void* b_out, void* w_out, int n, int w,
                  const uint32_t* table, const uint32_t* keys, int members,
                  uint32_t start, int n_sweeps, int tile_r, int tile_c,
                  int threads, void* stream) {
  if (threads < 32 || threads > 512 || threads % 32 || n_sweeps < 1 ||
      tile_r < 1 || tile_c < 1 ||
      repro_torch::check_members<SweepMember>(members) ||
      (shard && members != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool batch = members > 1;
  const size_t smem = shard ? shard_smem_bytes(tile_r, tile_c, n_sweeps)
                            : resident_smem_bytes(tile_r, tile_c, n_sweeps);
  const void* kernel =
      shard   ? reinterpret_cast<const void*>(multispin_sweeps_kernel<true>)
      : batch ? reinterpret_cast<const void*>(multispin_sweeps_members_kernel)
              : reinterpret_cast<const void*>(multispin_sweeps_kernel<false>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch would report it
    return static_cast<int>(err);
  }
  const int words = w % 4 == 0 && tile_c % 4 == 0 && aligned(b_in, 16) &&
                    aligned(w_in, 16) && aligned(b_out, 16) &&
                    aligned(w_out, 16) && (!shard || aligned(widx, 16));
  const dim3 grid((w + tile_c - 1) / tile_c, (n + tile_r - 1) / tile_r,
                  members);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* bi = static_cast<const uint32_t*>(b_in);
  const uint32_t* wi = static_cast<const uint32_t*>(w_in);
  const uint32_t* gi = static_cast<const uint32_t*>(widx);
  uint32_t* bo = static_cast<uint32_t*>(b_out);
  uint32_t* wo = static_cast<uint32_t*>(w_out);
  if (batch) {
    multispin_sweeps_members_kernel<<<grid, threads, smem, s>>>(
        bi, wi, bo, wo, n, w, make_members(table, keys, members), start,
        n_sweeps, tile_r, tile_c, words);
    return static_cast<int>(cudaGetLastError());
  }
  KeyTable tab;
  std::memcpy(tab.v, table, sizeof(tab.v));
  const repro_torch::PhiloxKeys philox_keys(keys[0], keys[1]);
  if (shard) {
    multispin_sweeps_kernel<true><<<grid, threads, smem, s>>>(
        bi, wi, gi, bo, wo, n, w, tab, philox_keys, start, n_sweeps, tile_r,
        tile_c, words);
  } else {
    multispin_sweeps_kernel<false><<<grid, threads, smem, s>>>(
        bi, wi, gi, bo, wo, n, w, tab, philox_keys, start, n_sweeps, tile_r,
        tile_c, words);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kBatch>
int launch_update(void* target, const void* op, int n, int w, int is_black,
                  const uint32_t* thr, const uint32_t* keys, int members,
                  uint32_t offset, void* stream) {
  repro_torch::Members<UpdateMember, kBatch> records;
  for (int i = 0; i < members; ++i) {
    records.v[i].thr = make_thresholds(thr + kClasses * i);
    records.v[i].k0 = keys[2 * i];
    records.v[i].k1 = keys[2 * i + 1];
  }
  const int threads = w >= 256 ? 256 : ((w + 31) / 32) * 32;
  const dim3 grid(n, (w + threads - 1) / threads, members);
  multispin_update_kernel<kBatch>
      <<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<uint32_t*>(target), static_cast<const uint32_t*>(op), n,
          w, is_black, records, offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The most members one batched launch of this library takes.
int multispin_max_members() {
  const int a = repro_torch::max_members<UpdateMember>();
  const int b = repro_torch::max_members<SweepMember>();
  return a < b ? a : b;
}


// thr: the members' 10 thresholds each; keys: their (k0, k1) pairs;
// members 1 or a batch of stacked (n, w) planes
int multispin_update_launch(void* target, const void* op, int n, int w,
                            int is_black, const uint32_t* thr,
                            const uint32_t* keys, int members,
                            uint32_t offset, void* stream) {
  if (repro_torch::check_members<UpdateMember>(members)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return members > 1 ? launch_update<true>(target, op, n, w, is_black, thr,
                                           keys, members, offset, stream)
                     : launch_update<false>(target, op, n, w, is_black, thr,
                                            keys, 1, offset, stream);
}

long long multispin_resident_smem_bytes(int tile_r, int tile_c,
                                        int n_sweeps) {
  return static_cast<long long>(resident_smem_bytes(tile_r, tile_c, n_sweeps));
}

// table: the members' 16 key-table entries each; keys: their (k0, k1)
// pairs
int multispin_sweeps_resident_launch(const void* b_in, const void* w_in,
                                     void* b_out, void* w_out, int n, int w,
                                     const uint32_t* table,
                                     const uint32_t* keys, int members,
                                     uint32_t start, int n_sweeps, int tile_r,
                                     int tile_c, int threads, void* stream) {
  return launch_sweeps(false, b_in, w_in, nullptr, b_out, w_out, n, w, table,
                       keys, members, start, n_sweeps, tile_r, tile_c,
                       threads, stream);
}

long long multispin_shard_smem_bytes(int tile_r, int tile_c, int n_sweeps) {
  return static_cast<long long>(shard_smem_bytes(tile_r, tile_c, n_sweeps));
}

int multispin_shard_sweeps_launch(const void* b_in, const void* w_in,
                                  const void* widx, void* b_out, void* w_out,
                                  int n, int w, const uint32_t* table,
                                  uint32_t k0, uint32_t k1, uint32_t start,
                                  int n_sweeps, int tile_r, int tile_c,
                                  int threads, void* stream) {
  const uint32_t keys[2] = {k0, k1};
  return launch_sweeps(true, b_in, w_in, widx, b_out, w_out, n, w, table,
                       keys, 1, start, n_sweeps, tile_r, tile_c, threads,
                       stream);
}

}  // extern "C"
