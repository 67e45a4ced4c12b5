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
//   word gets the carry-save 3-bitplane count of its 4 neighbours
//   (8 logic operations) and the OR over the 10 (spin, count) classes of
//   class mask & (draw < t_class).  One thread per site would compute
//   each Philox call 4 times.  The group's words load and store as one
//   16-byte vector; the thread reads only its own target words, so the
//   update is in place.
//   Bound: as much by integer work (a quarter of a Philox call, 6 +
//   10 x 5 logic operations per word) as by its 12 bytes per word.
//
// * bitplane_sweeps_resident: n_sweeps full sweeps in one launch.
//   Replaces src/repro/kernels/bitplane/resident.py:
//   bitplane_sweeps_resident.  Temporal blocking on shared-memory tiles
//   as in csrc/stencil.cu: a tile of both planes plus a halo of 2k rows
//   and of 2k columns rounded up to a multiple of 4, so that the tile's
//   column origin and every thread's group stay 4-aligned and one
//   Philox call still serves one group.  Draws are keyed on the global
//   group index; input and output planes must differ.
//
// * bitplane_shard_sweeps: n_sweeps full sweeps of one halo-extended bit
//   shard of a sharded run.  Replaces src/repro/dist/kernels.py:
//   bitplane_shard_sweeps, which updates the whole extended shard in TPU
//   VMEM with wrap taps and draws once per word: lane lane[r, c] (0, 1,
//   2, else 3) of Philox at counter (off, 0, gidx[r, c], 0), since an
//   extended shard's columns need not start on a 4-site group.  Here the
//   temporal blocking of bitplane_sweeps_resident runs on the extended
//   plane (tiles wrapping over its own dims, a halo of 2 * n_sweeps rows
//   and of col_halo(n_sweeps) columns, the tile's columns rounded up to
//   whole groups), one thread per 4-word group.
//   Bound: Philox issue.  One call per word, as the TPU kernel makes, is
//   4 times the Philox work per word of bitplane_sweeps_resident; but
//   where a group's 4 words carry one gidx and the lanes 0, 1, 2, 3 in
//   order -- every group of the sharded driver's index planes at k = 2,
//   whose extended shards start 4 columns left of a group -- one call
//   serves the 4 words, as in the resident kernel, with the offset's work
//   hoisted (philox_lane0.cuh, HoistedPhilox::lanes: 18 products a
//   group).  The staging decides it once per group and keeps the group's
//   gidx and an aligned flag in shared memory (9.25 bytes a word with
//   both planes, against 13 with a gidx and a lane byte per word).  Any
//   other group draws per word inside the kernel, reading its gidx and
//   lanes from device memory (word_draws): the same kernel taking the
//   general case, exact for any index planes.  The planes and index
//   planes move as 16-byte groups where a group is 4-aligned in device
//   memory; the result equals the TPU kernel's on the whole extended
//   plane.  Input and output planes must differ.
//
// The two k-sweep kernels share the group update (update_group) and not
// one template, as csrc/stencil.cu's pair does: what sets them apart is
// all around it.  bitplane_sweeps_resident's planes are whole groups
// everywhere (h a multiple of 4, tiles on group boundaries), so it stages
// no index planes, keys each group on its own row and column and moves
// every group as 16 bytes; the shard kernel stages gidx and the aligned
// flag, takes any index planes and any width, and masks ragged edges.
// One template would also give the resident kernel the shard kernel's
// hoisted draws and loop, a redesign of that kernel measured on its own
// when it is taken up (ROADMAP.md, Queue 2).
//
// The accept compares the raw uint32 draw with 10 uint32 thresholds
// passed by value (repro_torch.core.multispin.acceptance_thresholds).

#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

#include "common.cuh"
#include "philox.cuh"
#include "philox_lane0.cuh"

namespace {

using repro_torch::make_thresholds;
using repro_torch::Thresholds;
using repro_torch::wrap;

constexpr int kGroup = 4;  // sites per Philox call

// The flip word of one target word: carry-save count of its 4
// neighbours, then OR over the 10 classes of mask & broadcast(u < t).
__device__ __forceinline__ uint32_t update_word(uint32_t t, uint32_t up,
                                                uint32_t down,
                                                uint32_t center,
                                                uint32_t side, uint32_t draw,
                                                const Thresholds& thr) {
  const uint32_t x = up ^ down;
  const uint32_t s = x ^ center;             // low bit of up+down+center
  const uint32_t k = (up & down) | (center & x);  // its carry
  const uint32_t n0 = s ^ side;
  const uint32_t k2 = s & side;
  const uint32_t n1 = k ^ k2;
  const uint32_t n2 = k & k2;
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

// The group of 4 target words at word j (a multiple of 4) of row i of an
// extended tile of rows of ec words, updated in place from op: the side
// neighbour is the next word (plus) or the one before, a group at the
// row's edge taking it wrapped within the row.  draws() gives the group's
// 4 draws; it runs after the group's loads.
template <class Draws>
__device__ __forceinline__ void update_group(uint32_t* tgt,
                                             const uint32_t* op, int i,
                                             int j, int ec, bool plus,
                                             const Thresholds& thr,
                                             Draws draws) {
  const int c = i * ec + j;
  const uint4 tv = *reinterpret_cast<const uint4*>(tgt + c);
  const uint4 cv = *reinterpret_cast<const uint4*>(op + c);
  const uint4 uv = *reinterpret_cast<const uint4*>(op + c - ec);
  const uint4 dv = *reinterpret_cast<const uint4*>(op + c + ec);
  const uint4 sv =
      plus ? make_uint4(cv.y, cv.z, cv.w,
                        op[i * ec + (j + kGroup == ec ? 0 : j + kGroup)])
           : make_uint4(op[i * ec + (j == 0 ? ec - 1 : j - 1)], cv.x, cv.y,
                        cv.z);
  const uint4 r = draws();
  uint4 out;
  out.x = update_word(tv.x, uv.x, dv.x, cv.x, sv.x, r.x, thr);
  out.y = update_word(tv.y, uv.y, dv.y, cv.y, sv.y, r.y, thr);
  out.z = update_word(tv.z, uv.z, dv.z, cv.z, sv.z, r.z, thr);
  out.w = update_word(tv.w, uv.w, dv.w, cv.w, sv.w, r.w, thr);
  *reinterpret_cast<uint4*>(tgt + c) = out;
}

// grid (n, ceil(h / 4 / blockDim.x)): blockIdx.x is the row
__global__ void bitplane_update_kernel(uint32_t* __restrict__ target,
                                       const uint32_t* __restrict__ op,
                                       int n, int h, int is_black,
                                       Thresholds thr, uint32_t k0,
                                       uint32_t k1, uint32_t offset) {
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
  uint4 out;
  out.x = update_word(tv.x, uv.x, dv.x, cv.x, sv.x, r.x, thr);
  out.y = update_word(tv.y, uv.y, dv.y, cv.y, sv.y, r.y, thr);
  out.z = update_word(tv.z, uv.z, dv.z, cv.z, sv.z, r.z, thr);
  out.w = update_word(tv.w, uv.w, dv.w, cv.w, sv.w, r.w, thr);
  *reinterpret_cast<uint4*>(target + base + col) = out;
}

// Column halo of k sweeps: 2k rounded up to a whole group.
__host__ __device__ inline int col_halo(int n_sweeps) {
  return (2 * n_sweeps + kGroup - 1) / kGroup * kGroup;
}

// Bytes before the planes in shared memory: global row and column
// indices of the extended tile, rounded up to 16 so that the planes take
// 16-byte accesses.
__host__ __device__ inline size_t index_bytes(int er, int ec) {
  return (4 * static_cast<size_t>(er + ec) + 15) / 16 * 16;
}

// Shared memory of one block: the indices, then both extended word
// planes.
__host__ __device__ inline size_t resident_smem_bytes(int tile_r, int tile_c,
                                                      int n_sweeps) {
  const int er = tile_r + 4 * n_sweeps;
  const int ec = tile_c + 2 * col_halo(n_sweeps);
  return index_bytes(er, ec) + 2 * 4 * static_cast<size_t>(er) * ec;
}

// grid (ceil(h / tile_c), ceil(n / tile_r)), 1-D blocks; tile_c is a
// multiple of 4.  A thread moves a group's 4 words as one 16-byte access,
// so that neighbouring threads hit neighbouring shared-memory banks.
__global__ void bitplane_sweeps_resident_kernel(
    const uint32_t* __restrict__ b_in, const uint32_t* __restrict__ w_in,
    uint32_t* __restrict__ b_out, uint32_t* __restrict__ w_out, int n, int h,
    Thresholds thr, uint32_t k0, uint32_t k1, uint32_t start, int n_sweeps,
    int tile_r, int tile_c) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int halo_r = 2 * n_sweeps;
  const int halo_c = col_halo(n_sweeps);
  const int er = tile_r + 2 * halo_r;
  const int ec = tile_c + 2 * halo_c;
  const int eg = ec / kGroup;
  const uint32_t groups = static_cast<uint32_t>(h / kGroup);
  int* s_row = reinterpret_cast<int*>(smem);
  int* s_col = s_row + er;
  uint32_t* s_b = reinterpret_cast<uint32_t*>(smem + index_bytes(er, ec));
  uint32_t* s_w = s_b + static_cast<size_t>(er) * ec;

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int r0 = blockIdx.y * tile_r - halo_r;
  const int c0 = blockIdx.x * tile_c - halo_c;  // a multiple of 4
  for (int i = tid; i < er; i += nthreads) s_row[i] = wrap(r0 + i, n);
  for (int j = tid; j < ec; j += nthreads) s_col[j] = wrap(c0 + j, h);
  __syncthreads();

  // a group's 4 columns are 4 consecutive global columns of one group
  for (int x = tid; x < er * eg; x += nthreads) {
    const int i = x / eg;
    const int j = kGroup * (x % eg);
    const size_t g = static_cast<size_t>(s_row[i]) * h + s_col[j];
    *reinterpret_cast<uint4*>(s_b + i * ec + j) =
        *reinterpret_cast<const uint4*>(b_in + g);
    *reinterpret_cast<uint4*>(s_w + i * ec + j) =
        *reinterpret_cast<const uint4*>(w_in + g);
  }
  __syncthreads();

  // After h half-sweeps only the cells at distance >= h from the edge of
  // the extended tile are still exact, and only those at distance
  // >= 2 * n_sweeps - h are still needed: half-sweep h (from 0) updates
  // the rows at distance >= h + 1 and the groups that hold a column at
  // that distance; the last one no more than the tile's groups.  A
  // group at the tile's edge takes its side neighbour wrapped within the
  // extended tile, which is as wrong as stale and spreads no faster.
  for (int s = 0; s < n_sweeps; ++s) {
    for (int color = 0; color < 2; ++color) {
      uint32_t* tgt = color ? s_w : s_b;
      const uint32_t* op = color ? s_b : s_w;
      // half_sweep_offset(start, s, color), uint32 wrap
      const uint32_t offset = start + 2u * static_cast<uint32_t>(s) +
                              static_cast<uint32_t>(color);
      const int margin = 2 * s + color + 1;
      const int q0 = margin / kGroup;
      const int ng = (ec - margin + kGroup - 1) / kGroup - q0;
      const int cells = (er - 2 * margin) * ng;
      for (int x = tid; x < cells; x += nthreads) {
        const int i = margin + x / ng;
        const int j = kGroup * (q0 + x % ng);
        const bool plus = ((s_row[i] & 1) != 0) == (color == 0);
        update_group(tgt, op, i, j, ec, plus, thr, [&] {
          return repro_torch::philox4x32_10(
              make_uint4(offset, 0u,
                         static_cast<uint32_t>(s_row[i]) * groups +
                             static_cast<uint32_t>(s_col[j] / kGroup),
                         0u),
              k0, k1);
        });
      }
      __syncthreads();
    }
  }

  const int rows = min(tile_r, n - blockIdx.y * tile_r);
  const int tg = min(tile_c, h - blockIdx.x * tile_c) / kGroup;
  for (int x = tid; x < rows * tg; x += nthreads) {
    const int i = x / tg;
    const int j = kGroup * (x % tg);
    const int c = (i + halo_r) * ec + j + halo_c;
    const size_t g = static_cast<size_t>(blockIdx.y * tile_r + i) * h +
                     blockIdx.x * tile_c + j;
    *reinterpret_cast<uint4*>(b_out + g) =
        *reinterpret_cast<const uint4*>(s_b + c);
    *reinterpret_cast<uint4*>(w_out + g) =
        *reinterpret_cast<const uint4*>(s_w + c);
  }
}

// Shared memory of one shard-kernel block: the extended tile's global row
// and column indices, both extended word planes, then per 4-word group its
// Philox group index and its aligned flag (one byte).  The extended tile
// is the tile, its columns rounded up to whole groups, with a halo of 2k
// rows and col_halo(k) columns.
__host__ __device__ inline size_t shard_smem_bytes(int tile_r, int tile_c,
                                                   int n_sweeps) {
  const int er = tile_r + 4 * n_sweeps;
  const int ec = (tile_c + kGroup - 1) / kGroup * kGroup +
                 2 * col_halo(n_sweeps);
  return index_bytes(er, ec) + 2 * 4 * static_cast<size_t>(er) * ec +
         (4 + 1) * static_cast<size_t>(er) * (ec / kGroup);
}

// The draws of a group that is not one aligned Philox group: per word,
// lane min(lane, 3) of the Philox call at the word's own group index,
// both read from device memory at row + cols[l].  Out of line, so that
// the update loop keeps one call per aligned group in its registers.
__device__ __noinline__ uint4 word_draws(const uint32_t* __restrict__ gidx,
                                         const uint32_t* __restrict__ lane,
                                         size_t row, const int* cols,
                                         uint32_t offset, uint32_t k0,
                                         uint32_t k1) {
  uint32_t d[kGroup];
#pragma unroll
  for (int l = 0; l < kGroup; ++l) {
    const size_t at = row + cols[l];
    const uint4 r =
        repro_torch::philox4x32_10(make_uint4(offset, 0u, gidx[at], 0u), k0,
                                   k1);
    const uint32_t ln = lane[at];
    d[l] = ln == 0 ? r.x : ln == 1 ? r.y : ln == 2 ? r.z : r.w;
  }
  return make_uint4(d[0], d[1], d[2], d[3]);
}

// grid (ceil(w / tile_c), ceil(n / tile_r)), 1-D blocks; n x w is the
// extended shard.  vec: every plane starts at a multiple of 16 bytes, so
// a group whose 4 words are consecutive in a row and 4-aligned moves as
// one 16-byte access.
__global__ void bitplane_shard_sweeps_kernel(
    const uint32_t* __restrict__ b_in, const uint32_t* __restrict__ w_in,
    const uint32_t* __restrict__ gidx, const uint32_t* __restrict__ lane,
    uint32_t* __restrict__ b_out, uint32_t* __restrict__ w_out, int n, int w,
    Thresholds thr, uint32_t k0, uint32_t k1, uint32_t start, int n_sweeps,
    int tile_r, int tile_c, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int halo_r = 2 * n_sweeps;
  const int halo_c = col_halo(n_sweeps);
  const int er = tile_r + 2 * halo_r;
  const int ec = (tile_c + kGroup - 1) / kGroup * kGroup + 2 * halo_c;
  const int eg = ec / kGroup;
  const int groups = er * eg;
  int* s_row = reinterpret_cast<int*>(smem);
  int* s_col = s_row + er;
  uint32_t* s_b = reinterpret_cast<uint32_t*>(smem + index_bytes(er, ec));
  uint32_t* s_w = s_b + static_cast<size_t>(er) * ec;
  uint32_t* s_g = s_w + static_cast<size_t>(er) * ec;
  uint8_t* s_aligned = reinterpret_cast<uint8_t*>(s_g + groups);

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int r0 = blockIdx.y * tile_r - halo_r;
  const int c0 = blockIdx.x * tile_c - halo_c;
  for (int i = tid; i < er; i += nthreads) s_row[i] = wrap(r0 + i, n);
  for (int j = tid; j < ec; j += nthreads) s_col[j] = wrap(c0 + j, w);
  __syncthreads();

  // a thread per group: its words of both planes, its group index, and
  // whether its 4 words are one Philox group, lanes 0, 1, 2, 3 in order
  for (int x = tid; x < groups; x += nthreads) {
    const int i = x / eg;
    const int j = kGroup * (x - i * eg);
    const size_t row = static_cast<size_t>(s_row[i]) * w;
    const size_t at = row + s_col[j];
    uint4 vb, vw, vg, vl;
    if (vec && s_col[j] + kGroup <= w && at % kGroup == 0) {
      vb = *reinterpret_cast<const uint4*>(b_in + at);
      vw = *reinterpret_cast<const uint4*>(w_in + at);
      vg = *reinterpret_cast<const uint4*>(gidx + at);
      vl = *reinterpret_cast<const uint4*>(lane + at);
    } else {
      size_t a[kGroup];
      for (int l = 0; l < kGroup; ++l) a[l] = row + s_col[j + l];
      vb = make_uint4(b_in[a[0]], b_in[a[1]], b_in[a[2]], b_in[a[3]]);
      vw = make_uint4(w_in[a[0]], w_in[a[1]], w_in[a[2]], w_in[a[3]]);
      vg = make_uint4(gidx[a[0]], gidx[a[1]], gidx[a[2]], gidx[a[3]]);
      vl = make_uint4(lane[a[0]], lane[a[1]], lane[a[2]], lane[a[3]]);
    }
    *reinterpret_cast<uint4*>(s_b + i * ec + j) = vb;
    *reinterpret_cast<uint4*>(s_w + i * ec + j) = vw;
    s_g[x] = vg.x;
    s_aligned[x] = vg.y == vg.x && vg.z == vg.x && vg.w == vg.x &&
                   vl.x == 0u && vl.y == 1u && vl.z == 2u && vl.w == 3u;
  }
  __syncthreads();

  // half-sweep q (from 0) updates the groups that hold a word at distance
  // >= q + 1 from the edge of the extended tile (rows likewise); a group
  // at the tile's edge takes its side neighbour wrapped within the
  // extended tile, as stale as a wrong one and spreading no faster
  for (int s = 0; s < n_sweeps; ++s) {
    for (int color = 0; color < 2; ++color) {
      uint32_t* tgt = color ? s_w : s_b;
      const uint32_t* op = color ? s_b : s_w;
      // half_sweep_offset(start, s, color), uint32 wrap
      const uint32_t offset = start + 2u * static_cast<uint32_t>(s) +
                              static_cast<uint32_t>(color);
      const repro_torch::HoistedPhilox philox(offset, k0, k1);
      const int margin = 2 * s + color + 1;
      const int q0 = margin / kGroup;
      const int ng = (ec - margin + kGroup - 1) / kGroup - q0;
      // the thread's cells x = tid + m * nthreads as (row, group), stepped
      // without a division
      const int di = nthreads / ng, dq = nthreads % ng;
      int i = margin + tid / ng, q = tid % ng;
      for (; i < er - margin; i += di, q += dq) {
        if (q >= ng) {
          q -= ng;
          ++i;
          if (i >= er - margin) break;
        }
        const int j = kGroup * (q0 + q);
        const bool plus = ((s_row[i] & 1) != 0) == (color == 0);
        const int gq = i * eg + q0 + q;
        update_group(tgt, op, i, j, ec, plus, thr, [&] {
          return s_aligned[gq]
                     ? philox.lanes(s_g[gq])
                     : word_draws(gidx, lane,
                                  static_cast<size_t>(s_row[i]) * w,
                                  s_col + j, offset, k0, k1);
        });
      }
      __syncthreads();
    }
  }

  const int rows = min(tile_r, n - static_cast<int>(blockIdx.y) * tile_r);
  const int cols = min(tile_c, w - static_cast<int>(blockIdx.x) * tile_c);
  const size_t origin = static_cast<size_t>(blockIdx.y) * tile_r * w +
                        static_cast<size_t>(blockIdx.x) * tile_c;
  if (vec && w % kGroup == 0 && tile_c % kGroup == 0) {
    // cols is a multiple of 4 too: whole groups
    const int tg = cols / kGroup;
    for (int x = tid; x < rows * tg; x += nthreads) {
      const int i = x / tg;
      const int j = kGroup * (x - i * tg);
      const int c = (i + halo_r) * ec + j + halo_c;
      const size_t g = origin + static_cast<size_t>(i) * w + j;
      *reinterpret_cast<uint4*>(b_out + g) =
          *reinterpret_cast<const uint4*>(s_b + c);
      *reinterpret_cast<uint4*>(w_out + g) =
          *reinterpret_cast<const uint4*>(s_w + c);
    }
  } else {
    for (int x = tid; x < rows * cols; x += nthreads) {
      const int i = x / cols;
      const int j = x - i * cols;
      const int c = (i + halo_r) * ec + j + halo_c;
      const size_t g = origin + static_cast<size_t>(i) * w + j;
      b_out[g] = s_b[c];
      w_out[g] = s_w[c];
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

}  // namespace

extern "C" {

int bitplane_update_launch(void* target, const void* op, int n, int h,
                           int is_black, const uint32_t* thr, uint32_t k0,
                           uint32_t k1, uint32_t offset, void* stream) {
  const int groups = h / kGroup;
  const int threads = groups >= 256 ? 256 : ((groups + 31) / 32) * 32;
  const dim3 grid(n, (groups + threads - 1) / threads);
  bitplane_update_kernel<<<grid, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(target), static_cast<const uint32_t*>(op), n, h,
      is_black, make_thresholds(thr), k0, k1, offset);
  return static_cast<int>(cudaGetLastError());
}

long long bitplane_resident_smem_bytes(int tile_r, int tile_c, int n_sweeps) {
  return static_cast<long long>(resident_smem_bytes(tile_r, tile_c, n_sweeps));
}

int bitplane_sweeps_resident_launch(const void* b_in, const void* w_in,
                                    void* b_out, void* w_out, int n, int h,
                                    const uint32_t* thr, uint32_t k0,
                                    uint32_t k1, uint32_t start, int n_sweeps,
                                    int tile_r, int tile_c, int threads,
                                    void* stream) {
  const size_t smem = resident_smem_bytes(tile_r, tile_c, n_sweeps);
  cudaError_t err = cudaFuncSetAttribute(
      bitplane_sweeps_resident_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch would report it
    return static_cast<int>(err);
  }
  const dim3 grid((h + tile_c - 1) / tile_c, (n + tile_r - 1) / tile_r);
  bitplane_sweeps_resident_kernel<<<grid, threads, smem,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(b_in), static_cast<const uint32_t*>(w_in),
      static_cast<uint32_t*>(b_out), static_cast<uint32_t*>(w_out), n, h,
      make_thresholds(thr), k0, k1, start, n_sweeps, tile_r, tile_c);
  return static_cast<int>(cudaGetLastError());
}

long long bitplane_shard_smem_bytes(int tile_r, int tile_c, int n_sweeps) {
  return static_cast<long long>(shard_smem_bytes(tile_r, tile_c, n_sweeps));
}

int bitplane_shard_sweeps_launch(const void* b_in, const void* w_in,
                                 const void* gidx, const void* lane,
                                 void* b_out, void* w_out, int n, int w,
                                 const uint32_t* thr, uint32_t k0,
                                 uint32_t k1, uint32_t start, int n_sweeps,
                                 int tile_r, int tile_c, int threads,
                                 void* stream) {
  const size_t smem = shard_smem_bytes(tile_r, tile_c, n_sweeps);
  cudaError_t err = cudaFuncSetAttribute(
      bitplane_shard_sweeps_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch would report it
    return static_cast<int>(err);
  }
  const dim3 grid((w + tile_c - 1) / tile_c, (n + tile_r - 1) / tile_r);
  bitplane_shard_sweeps_kernel<<<grid, threads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(b_in), static_cast<const uint32_t*>(w_in),
      static_cast<const uint32_t*>(gidx), static_cast<const uint32_t*>(lane),
      static_cast<uint32_t*>(b_out), static_cast<uint32_t*>(w_out), n, w,
      make_thresholds(thr), k0, k1, start, n_sweeps, tile_r, tile_c,
      aligned16({b_in, w_in, gidx, lane, b_out, w_out}));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
