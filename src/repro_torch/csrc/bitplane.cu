// Bitplane multi-spin coded Metropolis (32 replicas per uint32 word,
// bit r = replica r), for Hopper (sm_90a).
//
// Three kernels with a plain C interface (loaded with ctypes by
// repro_torch.kernels.bitplane and repro_torch.dist.kernels):
//
// * bitplane_update: one colour half-sweep of all 32 replicas.  Replaces
//   the Pallas kernel src/repro/kernels/bitplane/bitplane.py:
//   bitplane_update.  One thread per group of 4 consecutive sites of a
//   row: one Philox4x32-10 call at counter (off, 0, g, 0),
//   g = (r * h + c) / 4, gives the group's 4 draws, lane l to site
//   c + l, each shared by the 32 replicas of that site's word.  Each
//   word gets the carry-save 3-bitplane count of its 4 neighbours and
//   the accept (below).  One thread per site would compute each Philox
//   call 4 times.  The group's words load and store as one 16-byte
//   vector; the thread reads only its own target words, so the update
//   is in place.
//   Bound: bytes (12 a word) as much as integer work.
//
// * bitplane_sweeps_resident: n_sweeps full sweeps in one launch.
//   Replaces src/repro/kernels/bitplane/resident.py:
//   bitplane_sweeps_resident, which keeps both whole planes in TPU VMEM.
//   Temporal blocking on shared-memory tiles as in csrc/stencil.cu and
//   csrc/multispin.cu: a tile of both planes plus a halo of 2k rows and
//   of 2k columns rounded up to a multiple of 4, so that the tile's
//   column origin and every group stay 4-aligned and one Philox call
//   still serves one group.  Draws are keyed on the global group index;
//   input and output planes must differ.
//
// * bitplane_shard_sweeps: n_sweeps full sweeps of one halo-extended bit
//   shard of a sharded run.  Replaces src/repro/dist/kernels.py:
//   bitplane_shard_sweeps, which updates the whole extended shard in TPU
//   VMEM with wrap taps and draws once per word: lane lane[r, c] (0, 1,
//   2, else 3) of Philox at counter (off, 0, gidx[r, c], 0), since an
//   extended shard's columns need not start on a 4-site group.  Here the
//   temporal blocking runs on the extended plane as if it were a lattice
//   (tiles wrap over its own dims, the tile's columns rounded up to
//   whole groups).  Where a group's 4 words carry one gidx and the lanes
//   0, 1, 2, 3 in order -- every group of the sharded driver's index
//   planes at k = 2, whose extended shards start 4 columns left of a
//   group -- one call serves the 4 words; the staging decides it once a
//   group and keeps the group's gidx and an aligned flag in shared
//   memory (9.25 bytes a word with both planes).  Any other group draws
//   per word, reading its gidx and lanes from device memory
//   (word_draws): exact for any index planes.  The result equals the TPU
//   kernel's on the whole extended plane.  Input and output planes must
//   differ.
//
//   Both run one group loop (bitplane_sweeps_kernel<kShard, kThree>),
//   as the stencil and multispin pairs do: the k-sweep kernel keys a
//   group on its global row base plus its group column and stages no
//   index planes; the shard kernel keys it on the staged gidx.  Bound:
//   instruction issue.  What the design does about it: the group's 4
//   draws from HoistedPhilox::lanes (philox_lane0.cuh: what depends on
//   the offset made once a half-sweep from the key schedule the host
//   makes, 18 wide multiplies a group where a full call takes 20); the
//   three-threshold accept (below); no division or index load in the
//   loop: a warp takes a row and a lane a group, the row's parity and
//   key base made once a row, the group's column from the loop counter,
//   the lattice-edge tiles' column wrap in a loop of its own (kWrap);
//   the region one ring smaller each half-sweep and cut to the plane at
//   a ragged edge; a group's side neighbour at the edge of the region
//   read from the next word of shared memory, as stale as the wrapped
//   one it stands for and spreading no faster.
//
// The accept.  The 10 uint32 thresholds t[s * 5 + c]
// (repro_torch.core.multispin.acceptance_thresholds) of a ferromagnet
// take three values: 0xFFFFFFFF for the six classes whose energy does
// not rise, t4 for (s, c) = (1, 3) and (0, 1), t8 for (1, 4) and (0, 0).
// For classes of one threshold, OR over them of mask & (draw < t) is
// (OR of the masks) & (draw < t), so the flip word is three class masks
// (built from t and the count's bits with a few logic operations), each
// XORed into the word where the draw is below its threshold
// (Accept<true>: 3 compares and 3 predicated XORs).  The host checks the
// layout (repro_torch.kernels._words.accept_arg) and passes t4 and t8;
// a table of another layout takes the general accept, the OR over the 10
// classes of class mask & (draw < t_class) (Accept<false>), the second
// instantiation of each kernel.  Both give the same bits.
//
// Ensembles (common.cuh): bitplane_update and bitplane_sweeps_resident
// also run B members' stacked planes in one launch, blockIdx.z the
// member, each member's accept (t4 and t8, or its 10 thresholds) and
// Philox keys one record of a __grid_constant__ parameter (their kBatch
// instances; the shard kernel runs one member): what jax.vmap makes of
// the two pallas_calls under repro.api.session._EnsembleRunner.  A launch
// takes the three-threshold accept only where every member's table has
// a ferromagnet's layout, else the general one for all its members.

#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "common.cuh"
#include "philox.cuh"
#include "philox_lane0.cuh"

namespace {

using repro_torch::make_thresholds;
using repro_torch::PhiloxKeys;
using repro_torch::Thresholds;
using repro_torch::wrap_near;

constexpr int kGroup = 4;  // sites per Philox call

// word ^= mask where draw < threshold: a predicated XOR
__device__ __forceinline__ void xor_below(uint32_t& word, uint32_t draw,
                                          uint32_t threshold,
                                          uint32_t mask) {
  asm("{\n"
      "  .reg .pred p;\n"
      "  setp.lt.u32 p, %1, %2;\n"
      "  @p xor.b32 %0, %0, %3;\n"
      "}"
      : "+r"(word)
      : "r"(draw), "r"(threshold), "r"(mask));
}

template <bool kThree>
struct Accept;

// t4 and t8, every other class at 0xFFFFFFFF
template <>
struct Accept<true> {
  uint32_t t4, t8;

  // the new target word from its up-count bits (c = n0 + 2 n1 + 4 n2)
  __device__ __forceinline__ uint32_t next(uint32_t t, uint32_t n0,
                                           uint32_t n1, uint32_t n2,
                                           uint32_t draw) const {
    // c <= 4: c = 4 iff n2, c = 3 iff n0 n1, c = 1 iff n0 ~n1, c = 0 iff
    // none of the three.  Classes (1, 4), (0, 0) and (1, 3), (0, 1):
    const uint32_t m8 = (t & n2) | ~(t | n0 | n1 | n2);
    const uint32_t m4 = n0 & ~(t ^ n1);
    uint32_t out = t;
    xor_below(out, draw, 0xFFFFFFFFu, ~(m4 | m8));
    xor_below(out, draw, t4, m4);
    xor_below(out, draw, t8, m8);
    return out;
  }
};

// any 10 thresholds
template <>
struct Accept<false> {
  Thresholds thr;

  // OR over the 10 classes of mask & broadcast(draw < t)
  __device__ __forceinline__ uint32_t next(uint32_t t, uint32_t n0,
                                           uint32_t n1, uint32_t n2,
                                           uint32_t draw) const {
    uint32_t flip = 0;
#pragma unroll
    for (int sp = 0; sp < 2; ++sp) {
      const uint32_t sm = sp ? t : ~t;
#pragma unroll
      for (int c = 0; c < 5; ++c) {
        const uint32_t mask = sm & ((c & 1) ? n0 : ~n0) &
                              ((c & 2) ? n1 : ~n1) & ((c & 4) ? n2 : ~n2);
        const uint32_t accept = draw < thr.v[sp * 5 + c] ? 0xFFFFFFFFu : 0u;
        flip |= mask & accept;
      }
    }
    return t ^ flip;
  }
};

// The new target word t: the carry-save count of its 4 neighbours, then
// the accept.
template <bool kThree>
__device__ __forceinline__ uint32_t update_word(uint32_t t, uint32_t up,
                                                uint32_t down,
                                                uint32_t center,
                                                uint32_t side, uint32_t draw,
                                                const Accept<kThree>& acc) {
  const uint32_t x = up ^ down;
  const uint32_t s = x ^ center;             // low bit of up+down+center
  const uint32_t k = (up & down) | (center & x);  // its carry
  const uint32_t k2 = s & side;
  return acc.next(t, s ^ side, k ^ k2, k & k2, draw);
}

// The group's 4 words from their loads and draws.
template <bool kThree>
__device__ __forceinline__ uint4 update_group(uint4 tv, uint4 uv, uint4 dv,
                                              uint4 cv, uint4 sv, uint4 r,
                                              const Accept<kThree>& acc) {
  return make_uint4(update_word(tv.x, uv.x, dv.x, cv.x, sv.x, r.x, acc),
                    update_word(tv.y, uv.y, dv.y, cv.y, sv.y, r.y, acc),
                    update_word(tv.z, uv.z, dv.z, cv.z, sv.z, r.z, acc),
                    update_word(tv.w, uv.w, dv.w, cv.w, sv.w, r.w, acc));
}

// A member's record of bitplane_update: its accept and key.
template <bool kThree>
struct UpdateMember {
  Accept<kThree> acc;
  uint32_t k0, k1;
};

// grid (n, ceil(h / 4 / blockDim.x), members): blockIdx.x is the row
template <bool kThree, bool kBatch>
__global__ void bitplane_update_kernel(
    uint32_t* __restrict__ target, const uint32_t* __restrict__ op, int n,
    int h, int is_black,
    const __grid_constant__ repro_torch::Members<UpdateMember<kThree>, kBatch>
        members,
    uint32_t offset) {
  const int member = repro_torch::member_index<kBatch>();
  const Accept<kThree>& acc = members.v[member].acc;
  const uint32_t k0 = members.v[member].k0;
  const uint32_t k1 = members.v[member].k1;
  target += repro_torch::member_offset(member, n, h);
  op += repro_torch::member_offset(member, n, h);
  const int row = blockIdx.x;
  const int groups = h / kGroup;
  const int gc = blockIdx.y * blockDim.x + threadIdx.x;
  if (gc >= groups) return;
  const int col = kGroup * gc;
  const int up = row == 0 ? n - 1 : row - 1;
  const int down = row == n - 1 ? 0 : row + 1;
  // black targets take k+1 on odd rows, k-1 on even; white the reverse
  const bool plus = ((row & 1) != 0) == (is_black != 0);
  const size_t base = static_cast<size_t>(row) * h;
  const uint4 tv = *reinterpret_cast<const uint4*>(target + base + col);
  const uint4 cv = *reinterpret_cast<const uint4*>(op + base + col);
  const uint4 uv =
      *reinterpret_cast<const uint4*>(op + static_cast<size_t>(up) * h + col);
  const uint4 dv = *reinterpret_cast<const uint4*>(
      op + static_cast<size_t>(down) * h + col);
  const uint4 sv =
      plus ? make_uint4(cv.y, cv.z, cv.w,
                        op[base + (col + kGroup == h ? 0 : col + kGroup)])
           : make_uint4(op[base + (col == 0 ? h - 1 : col - 1)], cv.x, cv.y,
                        cv.z);
  const uint32_t g = static_cast<uint32_t>(row) *
                         static_cast<uint32_t>(groups) +
                     static_cast<uint32_t>(gc);
  const uint4 r =
      repro_torch::philox4x32_10(make_uint4(offset, 0u, g, 0u), k0, k1);
  *reinterpret_cast<uint4*>(target + base + col) =
      update_group(tv, uv, dv, cv, sv, r, acc);
}

// -- the k-sweep and shard kernels: one group loop ---------------------------
//
// An extended tile of both planes sits in shared memory: tile_r + 4k rows
// (a halo of 2k above and below) of whole 4-word groups (the tile's
// columns rounded up to a group, and col_halo(k) words on each side), at
// the most; a tile at a ragged edge of the plane fills fewer rows and
// groups of it.  Rows go to warps; a lane takes one group, the lanes of
// a warp consecutive groups, and moves its 4 words as 16 bytes.

// Column halo of k sweeps: 2k rounded up to a whole group.
__host__ __device__ inline int col_halo(int n_sweeps) {
  return (2 * n_sweeps + kGroup - 1) / kGroup * kGroup;
}

// Words of an extended tile row: the tile's columns rounded up to whole
// groups and the halo on each side.
__host__ __device__ inline int ext_words(int tile_c, int n_sweeps) {
  return (tile_c + kGroup - 1) / kGroup * kGroup + 2 * col_halo(n_sweeps);
}

// Shared memory of one k-sweep block: both extended planes.
__host__ __device__ inline size_t resident_smem_bytes(int tile_r, int tile_c,
                                                      int n_sweeps) {
  const size_t er = tile_r + 4 * n_sweeps;
  return 2 * 4 * er * ext_words(tile_c, n_sweeps);
}

// Shared memory of one shard block: both extended planes, then per group
// its Philox group index and its aligned flag (one byte).
__host__ __device__ inline size_t shard_smem_bytes(int tile_r, int tile_c,
                                                   int n_sweeps) {
  const size_t er = tile_r + 4 * n_sweeps;
  const size_t ec = ext_words(tile_c, n_sweeps);
  return 2 * 4 * er * ec + (4 + 1) * er * (ec / kGroup);
}

// A member's record of the k-sweep and shard kernels: its accept and key
// schedule.
template <bool kThree>
struct SweepMember {
  Accept<kThree> acc;
  PhiloxKeys keys;
};

// Where a block's extended tile sits: rows r0.., words c0.. of an n x w
// plane (both may lie off the plane and wrap); er rows of ew words hold
// the tile and its halo, rows pitch words apart in shared memory.
struct Tile {
  int n, w, r0, c0, er, ew, pitch;
};

// The shard kernel's staged index planes: per group of the extended tile
// (pitch / 4 a row) its gidx and whether it is one Philox group.
struct ShardIndex {
  const uint32_t* gidx;  // device memory, for word_draws
  const uint32_t* lane;
  const uint32_t* s_g;
  const uint8_t* s_aligned;
};

// The draws of a group that is not one aligned Philox group: per word,
// lane min(lane, 3) of the Philox call at the word's own group index,
// both read from device memory in the row at `row`, columns c, c + 1,
// c + 2, c + 3 wrapped modulo w.  Out of line, so that the group loop
// keeps one call per aligned group in its registers.
__device__ __noinline__ uint4 word_draws(const uint32_t* __restrict__ gidx,
                                         const uint32_t* __restrict__ lane,
                                         size_t row, int c, int w,
                                         uint32_t offset, uint32_t k0,
                                         uint32_t k1) {
  uint32_t d[kGroup];
#pragma unroll
  for (int l = 0; l < kGroup; ++l) {
    const size_t at = row + wrap_near(c + l, w);
    const uint4 r =
        repro_torch::philox4x32_10(make_uint4(offset, 0u, gidx[at], 0u), k0,
                                   k1);
    const uint32_t ln = lane[at];
    d[l] = ln == 0 ? r.x : ln == 1 ? r.y : ln == 2 ? r.z : r.w;
  }
  return make_uint4(d[0], d[1], d[2], d[3]);
}

// One row of half-sweep groups: groups [q_lo, q_hi) of extended row i
// (global or extended-plane row gr), the lanes of a warp on consecutive
// groups.  The side neighbour is the next word (kPlus) or the one
// before.  kWrap: a k-sweep tile at the lattice's edge, whose group
// columns wrap (each loop stays free of the other path's branches).
template <bool kShard, bool kThree, bool kPlus, bool kWrap>
__device__ __forceinline__ void sweep_row(
    uint32_t* __restrict__ tgt, const uint32_t* __restrict__ op,
    const ShardIndex& index, const Tile& tile, int i, int gr, int q_lo,
    int q_hi, uint32_t offset, const PhiloxKeys& keys,
    const repro_torch::HoistedPhilox& philox, const Accept<kThree>& acc) {
  const int row = i * tile.pitch;
  const int groups = tile.w / kGroup;
  // the k-sweep kernel's key of group column 0 of the row, and the
  // extended tile's first group column
  const uint32_t row_base =
      static_cast<uint32_t>(gr) * static_cast<uint32_t>(groups);
  const int gc0 = tile.c0 >> 2;
#pragma unroll 1
  for (int q = q_lo + (threadIdx.x & 31); q < q_hi; q += 32) {
    const int c = row + kGroup * q;
    const uint4 tv = *reinterpret_cast<const uint4*>(tgt + c);
    const uint4 cv = *reinterpret_cast<const uint4*>(op + c);
    const uint4 uv = *reinterpret_cast<const uint4*>(op + c - tile.pitch);
    const uint4 dv = *reinterpret_cast<const uint4*>(op + c + tile.pitch);
    const uint4 sv = kPlus ? make_uint4(cv.y, cv.z, cv.w, op[c + kGroup])
                           : make_uint4(op[c - 1], cv.x, cv.y, cv.z);
    uint4 r;
    if (kShard) {
      const int gq = (row >> 2) + q;
      r = index.s_aligned[gq]
              ? philox.lanes(index.s_g[gq])
              : word_draws(index.gidx, index.lane,
                           static_cast<size_t>(gr) * tile.w,
                           tile.c0 + kGroup * q, tile.w, offset, keys.k0[0],
                           keys.k1[0]);
    } else if (!kWrap) {
      r = philox.lanes(row_base + static_cast<uint32_t>(gc0 + q));
    } else {
      r = philox.lanes(row_base +
                       static_cast<uint32_t>(wrap_near(gc0 + q, groups)));
    }
    *reinterpret_cast<uint4*>(tgt + c) =
        update_group(tv, uv, dv, cv, sv, r, acc);
  }
}

// Half-sweep q of colour `color`: the groups that hold a word at distance
// >= m = q + 1 from the extended tile's edge, in rows at that distance
// (the words of a group nearer the edge are updated too; they are stale
// by then and never stored).  Row parity from the wrapped row: the
// lattice's (k-sweep) or the extended plane's own (shard).
template <bool kShard, bool kThree, bool kWrap>
__device__ __forceinline__ void half_sweep(
    uint32_t* __restrict__ tgt, const uint32_t* __restrict__ op,
    const ShardIndex& index, const Tile& tile, int m, int color,
    uint32_t offset, const PhiloxKeys& keys,
    const repro_torch::HoistedPhilox& philox, const Accept<kThree>& acc) {
  const int nwarps = blockDim.x >> 5;
  const int q_lo = m / kGroup;
  const int q_hi = (tile.ew - m + kGroup - 1) / kGroup;
  for (int i = m + (threadIdx.x >> 5); i < tile.er - m; i += nwarps) {
    const int gr = wrap_near(tile.r0 + i, tile.n);
    // black targets take k+1 on odd rows, k-1 on even; white the reverse
    if (((gr & 1) != 0) == (color == 0)) {
      sweep_row<kShard, kThree, true, kWrap>(tgt, op, index, tile, i, gr,
                                             q_lo, q_hi, offset, keys,
                                             philox, acc);
    } else {
      sweep_row<kShard, kThree, false, kWrap>(tgt, op, index, tile, i, gr,
                                              q_lo, q_hi, offset, keys,
                                              philox, acc);
    }
  }
}

// Stage the extended tile of both planes and, for a shard, each group's
// gidx and aligned flag: a warp a row, a lane a group.  A k-sweep tile's
// groups are groups of the lattice (w and c0 multiples of 4), each one
// 16-byte load; a shard's move as 16 bytes where they lie in the plane
// and line up (vec), else word by word with wrapped columns.
template <bool kShard>
__device__ __forceinline__ void load_tile(
    const uint32_t* __restrict__ b_in, const uint32_t* __restrict__ w_in,
    const uint32_t* __restrict__ gidx, const uint32_t* __restrict__ lane,
    uint32_t* s_b, uint32_t* s_w, uint32_t* s_g, uint8_t* s_aligned,
    const Tile& tile, bool vec) {
  const int nwarps = blockDim.x >> 5;
  const int eg = tile.ew / kGroup;
  for (int i = threadIdx.x >> 5; i < tile.er; i += nwarps) {
    const size_t row =
        static_cast<size_t>(wrap_near(tile.r0 + i, tile.n)) * tile.w;
    for (int q = threadIdx.x & 31; q < eg; q += 32) {
      const int j = i * tile.pitch + kGroup * q;
      const int col = wrap_near(tile.c0 + kGroup * q, tile.w);
      if (!kShard) {
        *reinterpret_cast<uint4*>(s_b + j) =
            *reinterpret_cast<const uint4*>(b_in + row + col);
        *reinterpret_cast<uint4*>(s_w + j) =
            *reinterpret_cast<const uint4*>(w_in + row + col);
        continue;
      }
      uint4 vb, vw, vg, vl;
      if (vec && col + kGroup <= tile.w && (row + col) % kGroup == 0) {
        vb = *reinterpret_cast<const uint4*>(b_in + row + col);
        vw = *reinterpret_cast<const uint4*>(w_in + row + col);
        vg = *reinterpret_cast<const uint4*>(gidx + row + col);
        vl = *reinterpret_cast<const uint4*>(lane + row + col);
      } else {
        size_t a[kGroup];
        for (int l = 0; l < kGroup; ++l) {
          a[l] = row + wrap_near(tile.c0 + kGroup * q + l, tile.w);
        }
        vb = make_uint4(b_in[a[0]], b_in[a[1]], b_in[a[2]], b_in[a[3]]);
        vw = make_uint4(w_in[a[0]], w_in[a[1]], w_in[a[2]], w_in[a[3]]);
        vg = make_uint4(gidx[a[0]], gidx[a[1]], gidx[a[2]], gidx[a[3]]);
        vl = make_uint4(lane[a[0]], lane[a[1]], lane[a[2]], lane[a[3]]);
      }
      *reinterpret_cast<uint4*>(s_b + j) = vb;
      *reinterpret_cast<uint4*>(s_w + j) = vw;
      s_g[j / kGroup] = vg.x;
      s_aligned[j / kGroup] = vg.y == vg.x && vg.z == vg.x && vg.w == vg.x &&
                              vl.x == 0u && vl.y == 1u && vl.z == 2u &&
                              vl.w == 3u;
    }
  }
}

// n_sweeps sweeps of one extended tile; the k-sweep kernel (kShard
// false) keys each group on the lattice group row * (w / 4) + column,
// the shard kernel on the group index staged from gidx.  grid (ceil(w /
// tile_c), ceil(n / tile_r), members), 1-D blocks of whole warps, at
// most 512.  The k-sweep kernel takes w and tile_c multiples of 4 and
// 16-byte aligned planes; the shard kernel any (vec: every plane pointer
// is 16-byte aligned).
template <bool kShard, bool kThree, bool kBatch>
__global__ void __launch_bounds__(512) bitplane_sweeps_kernel(
    const uint32_t* __restrict__ b_in, const uint32_t* __restrict__ w_in,
    const uint32_t* __restrict__ gidx, const uint32_t* __restrict__ lane,
    uint32_t* __restrict__ b_out, uint32_t* __restrict__ w_out, int n, int w,
    const __grid_constant__ repro_torch::Members<SweepMember<kThree>, kBatch>
        members,
    uint32_t start, int n_sweeps, int tile_r, int tile_c, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int member = repro_torch::member_index<kBatch>();
  const Accept<kThree>& acc = members.v[member].acc;
  const PhiloxKeys& keys = members.v[member].keys;
  const size_t plane = repro_torch::member_offset(member, n, w);
  b_in += plane;
  w_in += plane;
  b_out += plane;
  w_out += plane;
  const int halo = 2 * n_sweeps;
  const int hl = col_halo(n_sweeps);
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
  tile.ew = ext_words(cols, n_sweeps);
  tile.pitch = ext_words(tile_c, n_sweeps);
  const size_t plane_words =
      static_cast<size_t>(tile_r + 2 * halo) * tile.pitch;
  uint32_t* s_b = reinterpret_cast<uint32_t*>(smem);
  uint32_t* s_w = s_b + plane_words;
  uint32_t* s_g = s_w + plane_words;
  uint8_t* s_aligned =
      reinterpret_cast<uint8_t*>(s_g + plane_words / kGroup);
  const ShardIndex index{gidx, lane, s_g, s_aligned};
  load_tile<kShard>(b_in, w_in, gidx, lane, s_b, s_w, s_g, s_aligned, tile,
                    vec);
  __syncthreads();

  const bool inside = tile.c0 >= 0 && tile.c0 + tile.ew <= w;
  for (int s = 0; s < n_sweeps; ++s) {
    for (int color = 0; color < 2; ++color) {
      // half_sweep_offset(start, s, color), uint32 wrap
      const uint32_t offset = start + 2u * static_cast<uint32_t>(s) +
                              static_cast<uint32_t>(color);
      const repro_torch::HoistedPhilox philox(offset, keys);
      uint32_t* tgt = color ? s_w : s_b;
      const uint32_t* op = color ? s_b : s_w;
      const int m = 2 * s + color + 1;
      if (kShard || inside) {
        half_sweep<kShard, kThree, false>(tgt, op, index, tile, m, color,
                                          offset, keys, philox, acc);
      } else {
        half_sweep<kShard, kThree, true>(tgt, op, index, tile, m, color,
                                         offset, keys, philox, acc);
      }
      __syncthreads();
    }
  }

  // the tile's words
  const int lane_id = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const bool groups = vec && w % kGroup == 0 && tile_c % kGroup == 0;
  for (int i = threadIdx.x >> 5; i < rows; i += nwarps) {
    const size_t g = static_cast<size_t>(by * tile_r + i) * w +
                     static_cast<size_t>(bx) * tile_c;
    const int li = (i + halo) * tile.pitch + hl;
    if (groups) {
      // cols is a multiple of 4 too: whole groups
      for (int q = lane_id; q < cols / kGroup; q += 32) {
        reinterpret_cast<uint4*>(b_out + g)[q] =
            reinterpret_cast<const uint4*>(s_b + li)[q];
        reinterpret_cast<uint4*>(w_out + g)[q] =
            reinterpret_cast<const uint4*>(s_w + li)[q];
      }
    } else {
      for (int j = lane_id; j < cols; j += 32) {
        b_out[g + j] = s_b[li + j];
        w_out[g + j] = s_w[li + j];
      }
    }
  }
}

// 1 if every pointer is a multiple of 16 bytes
int aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return 0;
  }
  return 1;
}

// The accept of member i: Accept<true> of t4 and t8 (n_thr 2) or
// Accept<false> of t[s * 5 + c] (n_thr 10), from thr + n_thr * i.
template <bool kThree>
Accept<kThree> accept_of(const uint32_t* thr, int i);

template <>
Accept<true> accept_of<true>(const uint32_t* thr, int i) {
  return Accept<true>{thr[2 * i], thr[2 * i + 1]};
}

template <>
Accept<false> accept_of<false>(const uint32_t* thr, int i) {
  return Accept<false>{make_thresholds(thr + repro_torch::kClasses * i)};
}

// Launch the sweeps kernel with a given accept and members; returns the
// CUDA error (0: launched).
template <bool kShard, bool kThree, bool kBatch>
int launch_sweeps(const uint32_t* thr, const uint32_t* keys, int members,
                  const void* b_in, const void* w_in, const void* gidx,
                  const void* lane, void* b_out, void* w_out, int n, int w,
                  uint32_t start, int n_sweeps, int tile_r, int tile_c,
                  int threads, void* stream) {
  using Rec = SweepMember<kThree>;
  if (threads < 32 || threads > 512 || threads % 32 || n_sweeps < 1 ||
      tile_r < 1 || tile_c < 1 ||
      (!kShard && (w % kGroup || tile_c % kGroup)) ||
      repro_torch::check_members<Rec>(members)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = kShard ? shard_smem_bytes(tile_r, tile_c, n_sweeps)
                             : resident_smem_bytes(tile_r, tile_c, n_sweeps);
  cudaError_t err = cudaFuncSetAttribute(
      bitplane_sweeps_kernel<kShard, kThree, kBatch>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch would report it
    return static_cast<int>(err);
  }
  repro_torch::Members<Rec, kBatch> records;
  for (int i = 0; i < members; ++i) {
    records.v[i].acc = accept_of<kThree>(thr, i);
    records.v[i].keys = PhiloxKeys(keys[2 * i], keys[2 * i + 1]);
  }
  const dim3 grid((w + tile_c - 1) / tile_c, (n + tile_r - 1) / tile_r,
                  members);
  bitplane_sweeps_kernel<kShard, kThree, kBatch>
      <<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint32_t*>(b_in),
          static_cast<const uint32_t*>(w_in),
          static_cast<const uint32_t*>(gidx),
          static_cast<const uint32_t*>(lane), static_cast<uint32_t*>(b_out),
          static_cast<uint32_t*>(w_out), n, w, records, start, n_sweeps,
          tile_r, tile_c, aligned16({b_in, w_in, gidx, lane, b_out, w_out}));
  return static_cast<int>(cudaGetLastError());
}

// launch(three, batch) for the accept of n_thr thresholds a member (2:
// the three-threshold accept, 10: the general one) and `members`
// members, as std::integral_constant tags; returns the CUDA error.
template <class Launch>
int with_accept(int n_thr, int members, Launch launch) {
  using T = std::true_type;
  using F = std::false_type;
  if (n_thr == 2) {
    return members > 1 ? launch(T{}, T{}) : launch(T{}, F{});
  }
  if (n_thr == repro_torch::kClasses) {
    return members > 1 ? launch(F{}, T{}) : launch(F{}, F{});
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool kThree, bool kBatch>
int launch_update(const uint32_t* thr, const uint32_t* keys, int members,
                  void* target, const void* op, int n, int h, int is_black,
                  uint32_t offset, void* stream) {
  using Rec = UpdateMember<kThree>;
  if (repro_torch::check_members<Rec>(members)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  repro_torch::Members<Rec, kBatch> records;
  for (int i = 0; i < members; ++i) {
    records.v[i].acc = accept_of<kThree>(thr, i);
    records.v[i].k0 = keys[2 * i];
    records.v[i].k1 = keys[2 * i + 1];
  }
  const int groups = h / kGroup;
  const int threads = groups >= 256 ? 256 : ((groups + 31) / 32) * 32;
  const dim3 grid(n, (groups + threads - 1) / threads, members);
  bitplane_update_kernel<kThree, kBatch>
      <<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<uint32_t*>(target), static_cast<const uint32_t*>(op),
          n, h, is_black, records, offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// thr, n_thr: per member t4 and t8 (2) for the three-threshold accept, or
// the 10 thresholds (10) for the general one; keys: the members' (k0, k1)
// pairs; members 1 or a batch of stacked planes

// The most members one batched launch of this library takes.
int bitplane_max_members() {
  const int m[] = {repro_torch::max_members<UpdateMember<true>>(),
                   repro_torch::max_members<UpdateMember<false>>(),
                   repro_torch::max_members<SweepMember<true>>(),
                   repro_torch::max_members<SweepMember<false>>()};
  int out = m[0];
  for (int v : m) out = v < out ? v : out;
  return out;
}

int bitplane_update_launch(void* target, const void* op, int n, int h,
                           int is_black, const uint32_t* thr, int n_thr,
                           const uint32_t* keys, int members,
                           uint32_t offset, void* stream) {
  return with_accept(n_thr, members, [&](auto three, auto batch) {
    return launch_update<decltype(three)::value, decltype(batch)::value>(
        thr, keys, members, target, op, n, h, is_black, offset, stream);
  });
}

long long bitplane_resident_smem_bytes(int tile_r, int tile_c, int n_sweeps) {
  return static_cast<long long>(resident_smem_bytes(tile_r, tile_c, n_sweeps));
}

int bitplane_sweeps_resident_launch(const void* b_in, const void* w_in,
                                    void* b_out, void* w_out, int n, int h,
                                    const uint32_t* thr, int n_thr,
                                    const uint32_t* keys, int members,
                                    uint32_t start, int n_sweeps, int tile_r,
                                    int tile_c, int threads, void* stream) {
  return with_accept(n_thr, members, [&](auto three, auto batch) {
    return launch_sweeps<false, decltype(three)::value,
                         decltype(batch)::value>(
        thr, keys, members, b_in, w_in, nullptr, nullptr, b_out, w_out, n, h,
        start, n_sweeps, tile_r, tile_c, threads, stream);
  });
}

long long bitplane_shard_smem_bytes(int tile_r, int tile_c, int n_sweeps) {
  return static_cast<long long>(shard_smem_bytes(tile_r, tile_c, n_sweeps));
}

int bitplane_shard_sweeps_launch(const void* b_in, const void* w_in,
                                 const void* gidx, const void* lane,
                                 void* b_out, void* w_out, int n, int w,
                                 const uint32_t* thr, int n_thr, uint32_t k0,
                                 uint32_t k1, uint32_t start, int n_sweeps,
                                 int tile_r, int tile_c, int threads,
                                 void* stream) {
  const uint32_t keys[2] = {k0, k1};
  return with_accept(n_thr, 1, [&](auto three, auto) {
    return launch_sweeps<true, decltype(three)::value, false>(
        thr, keys, 1, b_in, w_in, gidx, lane, b_out, w_out, n, w, start,
        n_sweeps, tile_r, tile_c, threads, stream);
  });
}

}  // extern "C"
