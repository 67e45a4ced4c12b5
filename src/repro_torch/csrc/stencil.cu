// Checkerboard Metropolis on int8 compact colour planes, for Hopper (sm_90a).
//
// Three kernels with a plain C interface (loaded with ctypes by
// repro_torch.kernels.stencil and repro_torch.dist.kernels):
//
// * stencil_update: one colour half-sweep.  Replaces the Pallas kernel
//   src/repro/kernels/stencil/stencil.py:stencil_update.  Each cell
//   reads its own target spin and its four neighbours in the opposite
//   plane (periodic wrap, side tap by global row parity), draws lane 0
//   of Philox4x32-10 at counter (offset, 0, row*h + col, 0) and flips
//   iff u < table[s, nn].  Each thread reads only its own target cells,
//   so the target plane is updated in place.
//   Bound: the Philox rounds (integer multiplies and XORs), not bytes:
//   a cell moves 3 bytes but costs some 40 integer instructions.  So
//   the kernel runs the k-sweep kernels' word update (flip_cells) on
//   device memory: a thread takes a word of 4 cells and walks down its
//   column for kRowsPerThread rows, the up and centre words carried in
//   registers from the row before, the side word a byte permute of the
//   centre and the word beside it; the draws from a lane-0 HoistedPhilox
//   made on the host once a launch (a kernel parameter, its constants
//   in the constant bank); the accept the integer compare with the draw
//   bounds, read through the L1 cache from an 80-byte device table
//   (lanes of a warp take up to 10 of its entries at once, which the
//   constant bank would serve one address at a time); no shared memory,
//   no barrier, no division.  A plane whose width is not a multiple of 4
//   cells (its rows are then not whole aligned words) is read and
//   written cell by cell, the same update on words built from bytes.
//
// * stencil_sweeps_resident: n_sweeps full sweeps in one launch.
//   Replaces src/repro/kernels/stencil/resident.py:stencil_sweeps_resident,
//   which holds both whole planes in TPU VMEM.  A block has at most
//   227 KB of shared memory, so this kernel blocks in time on tiles
//   instead: each block loads a tile of both planes plus a halo of at
//   least 2 * n_sweeps (rows and compact columns, wrapped modulo n and
//   h), runs 2 * n_sweeps half-sweeps on the extended tile with a
//   barrier between them, and writes back only the tile.  Half-sweep q
//   updates the cells at distance >= q + 1 from the extended tile's
//   edge, which are exact, and every draw is keyed on the site's global
//   (row, col), so the tile is bit for bit what whole-lattice sweeps
//   give.  Input and output planes must differ: neighbouring blocks
//   read each other's tiles.
//
// * stencil_shard_sweeps: n_sweeps full sweeps of one halo-extended shard
//   of a sharded run.  Replaces src/repro/dist/kernels.py:
//   stencil_shard_sweeps, which holds the whole extended shard in TPU
//   VMEM and updates all of it with wrap taps, keying each site's draw on
//   a plane of uint32 global site indices (gidx) and taking the row
//   parity from the extended plane's own row index.  Here the temporal
//   blocking above runs on the extended plane as if it were a lattice
//   (tiles wrap over its own dims), with the key read from gidx, whose
//   extended tile each block stages in shared memory beside the planes
//   (6 bytes a cell; reading gidx from device memory in the loop
//   instead, with the smaller blocks that allows, was slower on the
//   card).  The result equals the TPU kernel's on the whole extended
//   plane, its edge rings included.  Input and output planes must
//   differ.
//
//   Both run one site loop (stencil_sweeps_kernel<shard>).  Bound:
//   instruction issue, not bytes (a site moves 2 bytes a launch but
//   needs 17 32x32 products): the Philox wide multiplies saturate the
//   FMA pipe, which issues IMAD.WIDE.U32 at about 32 a clock per SM,
//   half the rate of a 32-bit IMAD (repro_torch.analysis.issue_rate).
//   What the design does about it: lane 0 of Philox alone, with what
//   depends on the offset and key computed once a half-sweep
//   (philox_lane0.cuh: 15 wide multiplies, 2 half multiplies and 18
//   XORs a site); 4 cells a thread as one 32-bit shared word, its
//   neighbours read as words (the side word by a byte permute) and
//   counted per byte without carries; the accept an integer compare of
//   the raw draw with 64-bit bounds (draw_bounds, in shared memory)
//   instead of a float conversion; no division in any loop (rows and
//   columns from the loop counters, the wrap by subtraction, the
//   lattice-edge tiles' column wrap in a loop of its own); the region
//   one ring smaller each half-sweep; a warp a row and a lane a word, so
//   lanes idle only in a row's last pass; tiles loaded and stored as
//   4-byte words where they lie inside the plane and line up (gidx as
//   16 bytes), cell by cell elsewhere.  No tensor cores, TMA or wgmma:
//   the work is integer issue, neither a product of matrices nor a
//   stream of bytes.
//
// Ensembles (common.cuh): stencil_update and stencil_sweeps_resident
// also run B members' stacked planes in one launch, blockIdx.z the
// member, each member's draw bounds and Philox keys (stencil_update: its
// HoistedPhilox, and its 10 bounds in the device table at 10 x member)
// one record of a __grid_constant__ parameter (their kBatch instances;
// the shard kernel runs one member).  Replaces what jax.vmap makes of the
// two pallas_calls under repro.api.session._EnsembleRunner: one launch
// whose grid has a member axis.
//
// The accept of all three is the 10-entry float32 table (index (s > 0) *
// 5 + (nn + 4) / 2) built once on the host, never expf, so that the card,
// the CPU and the reference agree, taken as its exclusive bounds on the
// raw uint32 draw (draw_bounds): the decisions of u < p.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "common.cuh"
#include "philox.cuh"
#include "philox_lane0.cuh"

namespace {

constexpr int kTableSize = 10;

// -- the word update ---------------------------------------------------------
//
// 4 int8 cells of a row as one 32-bit word.  A word's four neighbour
// words in the opposite plane are read whole: up, down and centre, and
// the side word built from the centre and the word beside it with a byte
// permute.  The count of -1 neighbours of each byte is a sum of masked
// words without carries between the bytes, and turns into each cell's
// byte offset in the table of draw bounds (8 B entries, so one load with
// no bank conflicts in shared memory, one cache line in device memory).
// The cell flips iff its Philox draw is below the bound (integer
// compare, draw_bounds: the decisions of u < p of the float table).

// The side word of a word whose side neighbour is at column +1 (kPlus:
// cells 1..3 of the centre and cell 0 of the next word) or -1 (cell 3 of
// the word before and cells 0..2); `beside` is that next or previous
// word.
template <bool kPlus>
__device__ __forceinline__ uint32_t side_word(uint32_t centre,
                                              uint32_t beside) {
  return kPlus ? __byte_perm(centre, beside, 0x4321)
               : __byte_perm(beside, centre, 0x6543);
}

// The new target word t of 4 cells from its neighbour words; site[e]
// keys cell e's draw, `bounds` holds the 10 uint64 draw bounds.
__device__ __forceinline__ uint32_t flip_cells(
    uint32_t t, uint32_t up, uint32_t down, uint32_t centre, uint32_t side,
    const uint32_t (&site)[4], const repro_torch::HoistedPhilox& philox,
    const unsigned char* __restrict__ bounds) {
  // bit 1 of a cell: clear for +1 (0x01), set for -1 (0xFF)
  constexpr uint32_t kDown = 0x02020202u;
  // per byte: twice the number of -1 neighbours, at most 8
  const uint32_t down2 = (up & kDown) + (down & kDown) + (centre & kDown) +
                         (side & kDown);
  // per byte: 8 x the table index 5 (t > 0) + (nn + 4) / 2, which is
  // 9 - down - 5 (t < 0): at most 72, so no byte carries into the next
  const uint32_t offset8 = (0x12121212u - down2 - 5u * (t & kDown)) << 2;
  uint32_t flip = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t draw = philox(site[e]);
    const unsigned long long bound =
        *reinterpret_cast<const unsigned long long*>(
            bounds + ((offset8 >> (8 * e)) & 0xFFu));
    // 0x01 ^ 0xFE = 0xFF and back
    if (draw < bound) flip |= 0xFEu << (8 * e);
  }
  return t ^ flip;
}

// -- stencil_update: the word update on device memory ------------------------

// rows a thread walks down its word column
constexpr int kRowsPerThread = 16;

// The cells of an n x h int8 plane as words of 4: nw = ceil(h / 4) words
// a row, moved as 32-bit words (kWords: h a multiple of 4, the planes
// 4-byte aligned) or cell by cell, a word's cells past the row's end 0
// and never stored.
template <bool kWords>
struct Cells {
  int h, nw;

  __device__ __forceinline__ uint32_t load(const int8_t* __restrict__ p,
                                           int r, int wc) const {
    if (kWords) {
      return reinterpret_cast<const uint32_t*>(p)[static_cast<size_t>(r) *
                                                   nw + wc];
    }
    uint32_t v = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 4 * wc + e;
      if (col < h) {
        v |= static_cast<uint32_t>(static_cast<uint8_t>(
                 p[static_cast<size_t>(r) * h + col]))
             << (8 * e);
      }
    }
    return v;
  }

  __device__ __forceinline__ void store(int8_t* __restrict__ p, int r,
                                        int wc, uint32_t v) const {
    if (kWords) {
      reinterpret_cast<uint32_t*>(p)[static_cast<size_t>(r) * nw + wc] = v;
      return;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 4 * wc + e;
      if (col < h) {
        p[static_cast<size_t>(r) * h + col] =
            static_cast<int8_t>(v >> (8 * e));
      }
    }
  }

  // the side word of word wc of row r, its side neighbour at +1 (kPlus)
  // or -1, wrapped within the row
  template <bool kPlus>
  __device__ __forceinline__ uint32_t side(const int8_t* __restrict__ p,
                                           int r, int wc, uint32_t centre,
                                           int beside) const {
    if (kWords) return side_word<kPlus>(centre, load(p, r, beside));
    uint32_t v = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 4 * wc + e;
      const int sc = kPlus ? (col + 1 >= h ? 0 : col + 1)
                           : (col == 0 ? h - 1 : col - 1);
      v |= static_cast<uint32_t>(static_cast<uint8_t>(
               p[static_cast<size_t>(r) * h + sc]))
           << (8 * e);
    }
    return v;
  }
};

// grid (ceil(nw / blockDim.x), ceil(n / kRowsPerThread), members): a
// thread takes word column wc of kRowsPerThread rows, top to bottom
template <bool kWords, bool kBatch>
__global__ void __launch_bounds__(256) stencil_update_kernel(
    int8_t* __restrict__ target, const int8_t* __restrict__ op, int n, int h,
    int is_black, const unsigned long long* __restrict__ bounds,
    const __grid_constant__ repro_torch::Members<repro_torch::HoistedPhilox,
                                                 kBatch> philoxes) {
  const int member = repro_torch::member_index<kBatch>();
  const repro_torch::HoistedPhilox& philox = philoxes.v[member];
  target += repro_torch::member_offset(member, n, h);
  op += repro_torch::member_offset(member, n, h);
  bounds += kTableSize * member;
  const Cells<kWords> cells{h, (h + 3) >> 2};
  const int wc = static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x);
  if (wc >= cells.nw) return;
  const int r_lo = static_cast<int>(blockIdx.y) * kRowsPerThread;
  const int r_hi = min(n, r_lo + kRowsPerThread);
  // the words beside this one in its row, wrapped
  const int next = wc + 1 == cells.nw ? 0 : wc + 1;
  const int prev = wc == 0 ? cells.nw - 1 : wc - 1;
  const unsigned char* b8 = reinterpret_cast<const unsigned char*>(bounds);
  uint32_t up = cells.load(op, r_lo == 0 ? n - 1 : r_lo - 1, wc);
  uint32_t centre = cells.load(op, r_lo, wc);
  uint32_t base = static_cast<uint32_t>(r_lo) * static_cast<uint32_t>(h) +
                  static_cast<uint32_t>(4 * wc);
#pragma unroll 1
  for (int r = r_lo; r < r_hi; ++r) {
    const uint32_t down = cells.load(op, r + 1 == n ? 0 : r + 1, wc);
    // black targets take (i, k+1) on odd rows, (i, k-1) on even; white
    // the reverse
    const uint32_t side =
        ((r & 1) != 0) == (is_black != 0)
            ? cells.template side<true>(op, r, wc, centre, next)
            : cells.template side<false>(op, r, wc, centre, prev);
    const uint32_t site[4] = {base, base + 1, base + 2, base + 3};
    const uint32_t t = cells.load(target, r, wc);
    cells.store(target, r, wc,
                flip_cells(t, up, down, centre, side, site, philox, b8));
    up = centre;
    centre = down;
    base += static_cast<uint32_t>(h);
  }
}

// -- the k-sweep and shard kernels: one site loop --------------------------
//
// An extended tile of both planes sits in shared memory as rows of whole
// 32-bit words, 4 int8 cells each: tile_r + 4k rows (a halo of 2k above
// and below) by ext_cols() cells (a halo of at least 2k on each side, the
// left one rounded up to a word so that a tile's words line up with the
// plane's).  Rows go to warps; a lane takes one word of 4 consecutive
// cells of its row (the word update above, its draw bounds at the start
// of shared memory), and the lanes of a warp take consecutive words.

// 10 exclusive bounds on the raw uint32 draw (repro_torch.core.
// metropolis.draw_bounds): 0 never flips, 2^32 always does
struct DrawBounds {
  unsigned long long v[kTableSize];
};

// A member's record of the k-sweep and shard kernels: its bounds and key
struct Member {
  DrawBounds bounds;
  uint32_t k0, k1;
};

// the bounds at the start of a block's shared memory, padded
constexpr int kBoundsBytes = 128;

using repro_torch::aligned;
using repro_torch::ext_cols;
using repro_torch::left_halo;
using repro_torch::wrap_near;

// Shared memory of one k-sweep block: the bounds, then both extended
// planes.
__host__ __device__ inline size_t resident_smem_bytes(int tile_r, int tile_c,
                                                      int n_sweeps) {
  const size_t er = tile_r + 4 * n_sweeps;
  return kBoundsBytes + 2 * er * ext_cols(tile_c, n_sweeps);
}

// Shared memory of one shard block: the bounds, the extended tile's site
// indices, then both extended planes.
__host__ __device__ inline size_t shard_smem_bytes(int tile_r, int tile_c,
                                                   int n_sweeps) {
  const size_t er = tile_r + 4 * n_sweeps;
  return kBoundsBytes + 6 * er * ext_cols(tile_c, n_sweeps);
}

// The new target word of 4 cells at shared word c of a row whose side
// neighbour is at column +1 (kPlus) or -1; site[e] keys cell e's draw.
template <bool kPlus>
__device__ __forceinline__ uint32_t update_word(
    uint32_t t, const uint32_t* __restrict__ op, int c, int pitch,
    const uint32_t (&site)[4], const repro_torch::HoistedPhilox& philox,
    const unsigned char* s_bounds) {
  const uint32_t centre = op[c];
  const uint32_t side = side_word<kPlus>(centre, op[kPlus ? c + 1 : c - 1]);
  return flip_cells(t, op[c - pitch], op[c + pitch], centre, side, site,
                    philox, s_bounds);
}

// Where a block's extended tile sits: rows r0.., cells c0.. of an n x h
// plane (both may lie off the plane and wrap), er rows of pitch words.
struct Tile {
  int n, h, r0, c0, er, pitch;
  // the tile's cells lie in the plane's columns without a wrap
  bool cols_inside;
};

// One row of half-sweep cells: words [w_lo, w_hi) of extended row i, the
// lanes of a warp on consecutive words.  kWrap: a k-sweep tile at the
// lattice's edge, whose columns wrap (each loop stays free of the other
// path's branches).
template <bool kShard, bool kPlus, bool kWrap>
__device__ __forceinline__ void sweep_row(
    uint32_t* __restrict__ tgt, const uint32_t* __restrict__ op,
    const uint4* __restrict__ s_g, const Tile& tile, int i, int gr,
    int w_lo, int w_hi, int lane, const repro_torch::HoistedPhilox& philox,
    const unsigned char* s_bounds) {
  const uint32_t row_base =
      static_cast<uint32_t>(gr) * static_cast<uint32_t>(tile.h);
#pragma unroll 1
  for (int wc = w_lo + lane; wc < w_hi; wc += 32) {
    const int c = i * tile.pitch + wc;
    uint32_t site[4];
    if (kShard) {
      const uint4 g = s_g[c];
      site[0] = g.x;
      site[1] = g.y;
      site[2] = g.z;
      site[3] = g.w;
    } else if (!kWrap) {
      const uint32_t base = row_base + static_cast<uint32_t>(tile.c0 + 4 * wc);
#pragma unroll
      for (int e = 0; e < 4; ++e) site[e] = base + e;
    } else {
      int gc = wrap_near(tile.c0 + 4 * wc, tile.h);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        site[e] = row_base + static_cast<uint32_t>(gc);
        gc = gc + 1 == tile.h ? 0 : gc + 1;
      }
    }
    tgt[c] = update_word<kPlus>(tgt[c], op, c, tile.pitch, site, philox,
                                s_bounds);
  }
}

// Half-sweep q of colour `color`: the cells at distance >= m = q + 1 from
// the extended tile's edge, in whole words (the cells of a word nearer
// the edge are updated too; they are stale by then and never stored).
// Row parity from the wrapped row: the lattice's (k-sweep) or the
// extended plane's own (shard).
template <bool kShard, bool kWrap>
__device__ __forceinline__ void half_sweep(
    uint32_t* __restrict__ tgt, const uint32_t* __restrict__ op,
    const uint4* __restrict__ s_g, const Tile& tile, int m, int color,
    const repro_torch::HoistedPhilox& philox,
    const unsigned char* s_bounds) {
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int w_lo = m >> 2;
  const int w_hi = (4 * tile.pitch - m + 3) >> 2;
  for (int i = m + (threadIdx.x >> 5); i < tile.er - m; i += nwarps) {
    const int gr = wrap_near(tile.r0 + i, tile.n);
    // black targets take (i, k+1) on odd rows, (i, k-1) on even; white
    // the reverse
    if (((gr & 1) != 0) == (color == 0)) {
      sweep_row<kShard, true, kWrap>(tgt, op, s_g, tile, i, gr, w_lo, w_hi,
                                     lane, philox, s_bounds);
    } else {
      sweep_row<kShard, false, kWrap>(tgt, op, s_g, tile, i, gr, w_lo, w_hi,
                                      lane, philox, s_bounds);
    }
  }
}

// Stage the extended tile of both planes (and, for a shard, of gidx):
// whole words (16 B of gidx) where the tile's columns lie in the plane
// and line up with words, else cell by cell with wrapped columns.
template <bool kShard>
__device__ __forceinline__ void load_tile(
    const int8_t* __restrict__ b_in, const int8_t* __restrict__ w_in,
    const uint32_t* __restrict__ gidx, uint32_t* s_b, uint32_t* s_w,
    uint32_t* s_g, const Tile& tile, bool words) {
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int ecp = 4 * tile.pitch;
  for (int i = threadIdx.x >> 5; i < tile.er; i += nwarps) {
    const size_t g = static_cast<size_t>(wrap_near(tile.r0 + i, tile.n)) *
                     tile.h;
    if (words) {
      const size_t at = g + tile.c0;
      const uint32_t* b = reinterpret_cast<const uint32_t*>(b_in + at);
      const uint32_t* w = reinterpret_cast<const uint32_t*>(w_in + at);
      for (int wc = lane; wc < tile.pitch; wc += 32) {
        s_b[i * tile.pitch + wc] = b[wc];
        s_w[i * tile.pitch + wc] = w[wc];
        if (kShard) {
          reinterpret_cast<uint4*>(s_g)[i * tile.pitch + wc] =
              reinterpret_cast<const uint4*>(gidx + at)[wc];
        }
      }
    } else {
      int8_t* sb = reinterpret_cast<int8_t*>(s_b) + i * ecp;
      int8_t* sw = reinterpret_cast<int8_t*>(s_w) + i * ecp;
      int gc = wrap_near(tile.c0 + lane, tile.h);
      for (int j = lane; j < ecp; j += 32) {
        sb[j] = b_in[g + gc];
        sw[j] = w_in[g + gc];
        if (kShard) s_g[i * ecp + j] = gidx[g + gc];
        gc = wrap_near(gc + 32, tile.h);
      }
    }
  }
}

// n_sweeps sweeps of one extended tile; the k-sweep kernel (kShard
// false) keys each draw on the lattice site row * h + col, the shard
// kernel on the site index staged from gidx.  grid (ceil(h / tile_c),
// ceil(n / tile_r), members), 1-D blocks of whole warps.  `words`: h and
// tile_c are multiples of 4 and every plane pointer is 4-byte aligned
// (gidx 16).
template <bool kShard, bool kBatch>
__global__ void stencil_sweeps_kernel(
    const int8_t* __restrict__ b_in, const int8_t* __restrict__ w_in,
    const uint32_t* __restrict__ gidx, int8_t* __restrict__ b_out,
    int8_t* __restrict__ w_out, int n, int h,
    const __grid_constant__ repro_torch::Members<Member, kBatch> members,
    uint32_t start, int n_sweeps, int tile_r, int tile_c, int words) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int member = repro_torch::member_index<kBatch>();
  const DrawBounds& bounds = members.v[member].bounds;
  const uint32_t k0 = members.v[member].k0;
  const uint32_t k1 = members.v[member].k1;
  const size_t plane = repro_torch::member_offset(member, n, h);
  b_in += plane;
  w_in += plane;
  b_out += plane;
  w_out += plane;
  const int halo = 2 * n_sweeps;
  const int hl = left_halo(n_sweeps);
  Tile tile;
  tile.n = n;
  tile.h = h;
  tile.r0 = static_cast<int>(blockIdx.y) * tile_r - halo;
  tile.c0 = static_cast<int>(blockIdx.x) * tile_c - hl;
  tile.er = tile_r + 2 * halo;
  tile.pitch = ext_cols(tile_c, n_sweeps) >> 2;
  tile.cols_inside = tile.c0 >= 0 && tile.c0 + 4 * tile.pitch <= h;
  const size_t plane_words = static_cast<size_t>(tile.er) * tile.pitch;
  uint32_t* s_g = reinterpret_cast<uint32_t*>(smem + kBoundsBytes);
  uint32_t* s_b = s_g + (kShard ? 4 * plane_words : 0);
  uint32_t* s_w = s_b + plane_words;
  // constant indices: the bounds stay in the parameter space
#pragma unroll
  for (int e = 0; e < kTableSize; ++e) {
    if (threadIdx.x == e) {
      reinterpret_cast<unsigned long long*>(smem)[e] = bounds.v[e];
    }
  }
  load_tile<kShard>(b_in, w_in, gidx, s_b, s_w, s_g, tile,
                    words && tile.cols_inside);
  __syncthreads();

  for (int s = 0; s < n_sweeps; ++s) {
    for (int color = 0; color < 2; ++color) {
      // half_sweep_offset(start, s, color), uint32 wrap
      const repro_torch::HoistedPhilox philox(
          start + 2u * static_cast<uint32_t>(s) + static_cast<uint32_t>(color),
          k0, k1);
      uint32_t* tgt = color ? s_w : s_b;
      const uint32_t* op = color ? s_b : s_w;
      const uint4* g4 = reinterpret_cast<const uint4*>(s_g);
      const int m = 2 * s + color + 1;
      if (kShard || tile.cols_inside) {
        half_sweep<kShard, false>(tgt, op, g4, tile, m, color, philox, smem);
      } else {
        half_sweep<kShard, true>(tgt, op, g4, tile, m, color, philox, smem);
      }
      __syncthreads();
    }
  }

  // the tile's cells that lie in the plane
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int rows = min(tile_r, n - static_cast<int>(blockIdx.y) * tile_r);
  const int cols = min(tile_c, h - static_cast<int>(blockIdx.x) * tile_c);
  for (int i = threadIdx.x >> 5; i < rows; i += nwarps) {
    const size_t g = static_cast<size_t>(blockIdx.y * tile_r + i) * h +
                     static_cast<size_t>(blockIdx.x) * tile_c;
    const int li = (i + halo) * tile.pitch;
    if (words) {
      uint32_t* b = reinterpret_cast<uint32_t*>(b_out + g);
      uint32_t* w = reinterpret_cast<uint32_t*>(w_out + g);
      for (int wc = lane; wc < (cols >> 2); wc += 32) {
        b[wc] = s_b[li + (hl >> 2) + wc];
        w[wc] = s_w[li + (hl >> 2) + wc];
      }
    } else {
      const int8_t* sb = reinterpret_cast<const int8_t*>(s_b + li) + hl;
      const int8_t* sw = reinterpret_cast<const int8_t*>(s_w + li) + hl;
      for (int j = lane; j < cols; j += 32) {
        b_out[g + j] = sb[j];
        w_out[g + j] = sw[j];
      }
    }
  }
}

// The records of `members` members from their bounds (10 each) and key
// pairs (k0, k1 each).
template <bool kBatch>
repro_torch::Members<Member, kBatch> make_members(
    const unsigned long long* bounds, const uint32_t* keys, int members) {
  repro_torch::Members<Member, kBatch> out;
  for (int i = 0; i < members; ++i) {
    std::memcpy(out.v[i].bounds.v, bounds + kTableSize * i,
                sizeof(out.v[i].bounds.v));
    out.v[i].k0 = keys[2 * i];
    out.v[i].k1 = keys[2 * i + 1];
  }
  return out;
}

// Launch one of the three (the shard kernel, the k-sweep kernel of one
// member or of `members`); returns the CUDA error (0: launched).
int launch_sweeps(bool shard, const void* b_in, const void* w_in,
                  const void* gidx, void* b_out, void* w_out, int n, int h,
                  const unsigned long long* bounds, const uint32_t* keys,
                  int members, uint32_t start, int n_sweeps, int tile_r,
                  int tile_c, int threads, void* stream) {
  if (threads < 32 || threads > 1024 || threads % 32 || n_sweeps < 1 ||
      tile_r < 1 || tile_c < 1 ||
      repro_torch::check_members<Member>(members) || (shard && members != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool batch = members > 1;
  const size_t smem = shard ? shard_smem_bytes(tile_r, tile_c, n_sweeps)
                            : resident_smem_bytes(tile_r, tile_c, n_sweeps);
  const void* kernel =
      shard ? reinterpret_cast<const void*>(stencil_sweeps_kernel<true, false>)
      : batch
          ? reinterpret_cast<const void*>(stencil_sweeps_kernel<false, true>)
          : reinterpret_cast<const void*>(stencil_sweeps_kernel<false, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch would report it
    return static_cast<int>(err);
  }
  const int words = h % 4 == 0 && tile_c % 4 == 0 && aligned(b_in, 4) &&
                    aligned(w_in, 4) && aligned(b_out, 4) &&
                    aligned(w_out, 4) && (!shard || aligned(gidx, 16));
  const dim3 grid((h + tile_c - 1) / tile_c, (n + tile_r - 1) / tile_r,
                  members);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* bi = static_cast<const int8_t*>(b_in);
  const int8_t* wi = static_cast<const int8_t*>(w_in);
  const uint32_t* gi = static_cast<const uint32_t*>(gidx);
  int8_t* bo = static_cast<int8_t*>(b_out);
  int8_t* wo = static_cast<int8_t*>(w_out);
  if (shard) {
    stencil_sweeps_kernel<true, false><<<grid, threads, smem, s>>>(
        bi, wi, gi, bo, wo, n, h, make_members<false>(bounds, keys, 1), start,
        n_sweeps, tile_r, tile_c, words);
  } else if (batch) {
    stencil_sweeps_kernel<false, true><<<grid, threads, smem, s>>>(
        bi, wi, gi, bo, wo, n, h, make_members<true>(bounds, keys, members),
        start, n_sweeps, tile_r, tile_c, words);
  } else {
    stencil_sweeps_kernel<false, false><<<grid, threads, smem, s>>>(
        bi, wi, gi, bo, wo, n, h, make_members<false>(bounds, keys, 1), start,
        n_sweeps, tile_r, tile_c, words);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kBatch>
int launch_update(void* target, const void* op, int n, int h, int is_black,
                  const void* bounds, const uint32_t* keys, int members,
                  uint32_t offset, void* stream) {
  const int nw = (h + 3) / 4;
  const int threads = nw >= 256 ? 256 : ((nw + 31) / 32) * 32;
  const dim3 grid((nw + threads - 1) / threads,
                  (n + kRowsPerThread - 1) / kRowsPerThread, members);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* t = static_cast<int8_t*>(target);
  const int8_t* o = static_cast<const int8_t*>(op);
  const unsigned long long* b = static_cast<const unsigned long long*>(bounds);
  repro_torch::Members<repro_torch::HoistedPhilox, kBatch> philoxes;
  for (int i = 0; i < members; ++i) {
    philoxes.v[i] =
        repro_torch::HoistedPhilox(offset, keys[2 * i], keys[2 * i + 1]);
  }
  if (h % 4 == 0 && aligned(target, 4) && aligned(op, 4)) {
    stencil_update_kernel<true, kBatch><<<grid, threads, 0, s>>>(
        t, o, n, h, is_black, b, philoxes);
  } else {
    stencil_update_kernel<false, kBatch><<<grid, threads, 0, s>>>(
        t, o, n, h, is_black, b, philoxes);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The most members one batched launch of this library takes.
int stencil_max_members() {
  const int a = repro_torch::max_members<Member>();
  const int b = repro_torch::max_members<repro_torch::HoistedPhilox>();
  return a < b ? a : b;
}

// bounds: the members' 10 uint64 draw bounds each in device memory; keys:
// their (k0, k1) pairs; members 1 or a batch of stacked (n, h) planes
int stencil_update_launch(void* target, const void* op, int n, int h,
                          int is_black, const void* bounds,
                          const uint32_t* keys, int members, uint32_t offset,
                          void* stream) {
  if (repro_torch::check_members<repro_torch::HoistedPhilox>(members)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return members > 1 ? launch_update<true>(target, op, n, h, is_black, bounds,
                                           keys, members, offset, stream)
                     : launch_update<false>(target, op, n, h, is_black,
                                            bounds, keys, 1, offset, stream);
}

long long stencil_resident_smem_bytes(int tile_r, int tile_c, int n_sweeps) {
  return static_cast<long long>(resident_smem_bytes(tile_r, tile_c, n_sweeps));
}

// bounds: the members' 10 draw bounds each; keys: their (k0, k1) pairs
int stencil_sweeps_resident_launch(const void* b_in, const void* w_in,
                                   void* b_out, void* w_out, int n, int h,
                                   const unsigned long long* bounds,
                                   const uint32_t* keys, int members,
                                   uint32_t start, int n_sweeps, int tile_r,
                                   int tile_c, int threads, void* stream) {
  return launch_sweeps(false, b_in, w_in, nullptr, b_out, w_out, n, h,
                       bounds, keys, members, start, n_sweeps, tile_r, tile_c,
                       threads, stream);
}

long long stencil_shard_smem_bytes(int tile_r, int tile_c, int n_sweeps) {
  return static_cast<long long>(shard_smem_bytes(tile_r, tile_c, n_sweeps));
}

int stencil_shard_sweeps_launch(const void* b_in, const void* w_in,
                                const void* gidx, void* b_out, void* w_out,
                                int n, int w, const unsigned long long* bounds,
                                uint32_t k0, uint32_t k1, uint32_t start,
                                int n_sweeps, int tile_r, int tile_c,
                                int threads, void* stream) {
  const uint32_t keys[2] = {k0, k1};
  return launch_sweeps(true, b_in, w_in, gidx, b_out, w_out, n, w, bounds,
                       keys, 1, start, n_sweeps, tile_r, tile_c, threads,
                       stream);
}

}  // extern "C"
