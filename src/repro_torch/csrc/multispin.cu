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
//   in time on tiles of words: a tile of both planes plus a halo of
//   2 * n_sweeps word rows and word columns (the side tap reaches one
//   word over per half-sweep), 2 * n_sweeps half-sweeps with a barrier
//   between them, and a write-back of the tile only.  Draws are keyed on
//   the global word index, so the tile is bit for bit what whole-plane
//   sweeps give.  Input and output planes must differ.
//
// * multispin_shard_sweeps: n_sweeps full sweeps of one halo-extended
//   word shard of a sharded run.  Replaces src/repro/dist/kernels.py:
//   multispin_shard_sweeps, which updates the whole extended shard in
//   TPU VMEM with wrap taps, keying each word's two draws on a plane of
//   uint32 global word indices (widx).  The tiles of
//   multispin_sweeps_resident run on the extended plane as if it were a
//   lattice (wrapping over its own dims), with each block's extended tile
//   of widx staged in shared memory beside the planes (12 bytes per
//   word); the halo is 2 * n_sweeps words, since the funnel shift moves
//   a wrong value one word per half-sweep.  The result equals the TPU
//   kernel's on the whole extended plane.  Input and output planes must
//   differ.
//
// The accept compares the raw uint32 draw with 10 uint32 thresholds
// passed by value (repro_torch.core.multispin.acceptance_thresholds):
// no float, no exp.

#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "philox.cuh"

namespace {

using repro_torch::kClasses;
using repro_torch::make_thresholds;
using repro_torch::Thresholds;
using repro_torch::wrap;

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

// grid (n, ceil(w / blockDim.x)): blockIdx.x is the row
__global__ void multispin_update_kernel(uint32_t* __restrict__ target,
                                        const uint32_t* __restrict__ op,
                                        int n, int w, int is_black,
                                        Thresholds thr, uint32_t k0,
                                        uint32_t k1, uint32_t offset) {
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

// Shared memory of one block: global row and word-column indices of the
// extended tile, the thresholds (padded to 16 words), then both extended
// word planes.
__host__ __device__ inline size_t resident_smem_bytes(int tile_r, int tile_c,
                                                      int n_sweeps) {
  const size_t er = tile_r + 4 * n_sweeps;
  const size_t ec = tile_c + 4 * n_sweeps;
  return 4 * (er + ec) + 4 * 16 + 2 * 4 * er * ec;
}

// grid (ceil(w / tile_c), ceil(n / tile_r)), 1-D blocks; the work of each
// loop is spread over the whole block, so that no thread idles at the end
// of a row
__global__ void multispin_sweeps_resident_kernel(
    const uint32_t* __restrict__ b_in, const uint32_t* __restrict__ w_in,
    uint32_t* __restrict__ b_out, uint32_t* __restrict__ w_out, int n, int w,
    Thresholds thr, uint32_t k0, uint32_t k1, uint32_t start, int n_sweeps,
    int tile_r, int tile_c) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int halo = 2 * n_sweeps;
  const int er = tile_r + 2 * halo;
  const int ec = tile_c + 2 * halo;
  int* s_row = reinterpret_cast<int*>(smem);
  int* s_col = s_row + er;
  uint32_t* s_thr = reinterpret_cast<uint32_t*>(s_col + ec);
  uint32_t* s_b = s_thr + 16;
  uint32_t* s_w = s_b + static_cast<size_t>(er) * ec;

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int r0 = blockIdx.y * tile_r - halo;
  const int c0 = blockIdx.x * tile_c - halo;
  for (int i = tid; i < er; i += nthreads) s_row[i] = wrap(r0 + i, n);
  for (int j = tid; j < ec; j += nthreads) s_col[j] = wrap(c0 + j, w);
  load_thresholds(thr, s_thr, tid);
  __syncthreads();

  for (int c = tid; c < er * ec; c += nthreads) {
    const size_t g = static_cast<size_t>(s_row[c / ec]) * w + s_col[c % ec];
    s_b[c] = b_in[g];
    s_w[c] = w_in[g];
  }
  __syncthreads();

  // After h half-sweeps only the cells at distance >= h from the edge of
  // the extended tile are still exact, and only those at distance
  // >= 2 * n_sweeps - h are still needed: half-sweep h (from 0) updates
  // the cells at distance >= h + 1, and the last one the tile alone.
  for (int s = 0; s < n_sweeps; ++s) {
    for (int color = 0; color < 2; ++color) {
      uint32_t* tgt = color ? s_w : s_b;
      const uint32_t* op = color ? s_b : s_w;
      // half_sweep_offset(start, s, color), uint32 wrap
      const uint32_t offset = start + 2u * static_cast<uint32_t>(s) +
                              static_cast<uint32_t>(color);
      const int margin = 2 * s + color + 1;
      const int iw = ec - 2 * margin;
      const int cells = (er - 2 * margin) * iw;
      for (int x = tid; x < cells; x += nthreads) {
        const int i = margin + x / iw;
        const int j = margin + x % iw;
        const bool plus = ((s_row[i] & 1) != 0) == (color == 0);
        const int c = i * ec + j;
        const uint32_t center = op[c];
        const uint32_t nn = op[c - ec] + op[c + ec] + center +
                            side_word(center, op[plus ? c + 1 : c - 1], plus);
        tgt[c] = update_word(
            tgt[c], nn,
            static_cast<uint32_t>(s_row[i]) * static_cast<uint32_t>(w) +
                static_cast<uint32_t>(s_col[j]),
            offset, k0, k1, s_thr);
      }
      __syncthreads();
    }
  }

  const int rows = min(tile_r, n - blockIdx.y * tile_r);
  const int cols = min(tile_c, w - blockIdx.x * tile_c);
  for (int x = tid; x < rows * cols; x += nthreads) {
    const int i = x / cols;
    const int j = x % cols;
    const int c = (i + halo) * ec + j + halo;
    const size_t g =
        static_cast<size_t>(blockIdx.y * tile_r + i) * w + blockIdx.x * tile_c +
        j;
    b_out[g] = s_b[c];
    w_out[g] = s_w[c];
  }
}

// Shared memory of one shard-kernel block: row and word-column indices
// of the extended tile, the thresholds (padded to 16 words), the tile's
// word indices, then both extended word planes.
__host__ __device__ inline size_t shard_smem_bytes(int tile_r, int tile_c,
                                                   int n_sweeps) {
  const size_t er = tile_r + 4 * n_sweeps;
  const size_t ec = tile_c + 4 * n_sweeps;
  return 4 * (er + ec) + 4 * 16 + 3 * 4 * er * ec;
}

// grid (ceil(w / tile_c), ceil(n / tile_r)), 1-D blocks; n x w is the
// extended shard
__global__ void multispin_shard_sweeps_kernel(
    const uint32_t* __restrict__ b_in, const uint32_t* __restrict__ w_in,
    const uint32_t* __restrict__ widx, uint32_t* __restrict__ b_out,
    uint32_t* __restrict__ w_out, int n, int w, Thresholds thr, uint32_t k0,
    uint32_t k1, uint32_t start, int n_sweeps, int tile_r, int tile_c) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int halo = 2 * n_sweeps;
  const int er = tile_r + 2 * halo;
  const int ec = tile_c + 2 * halo;
  int* s_row = reinterpret_cast<int*>(smem);
  int* s_col = s_row + er;
  uint32_t* s_thr = reinterpret_cast<uint32_t*>(s_col + ec);
  uint32_t* s_g = s_thr + 16;
  uint32_t* s_b = s_g + static_cast<size_t>(er) * ec;
  uint32_t* s_w = s_b + static_cast<size_t>(er) * ec;

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int r0 = blockIdx.y * tile_r - halo;
  const int c0 = blockIdx.x * tile_c - halo;
  for (int i = tid; i < er; i += nthreads) s_row[i] = wrap(r0 + i, n);
  for (int j = tid; j < ec; j += nthreads) s_col[j] = wrap(c0 + j, w);
  load_thresholds(thr, s_thr, tid);
  __syncthreads();

  for (int c = tid; c < er * ec; c += nthreads) {
    const size_t g = static_cast<size_t>(s_row[c / ec]) * w + s_col[c % ec];
    s_b[c] = b_in[g];
    s_w[c] = w_in[g];
    s_g[c] = widx[g];
  }
  __syncthreads();

  // half-sweep q (from 0) updates the words at distance >= q + 1 from the
  // edge of the extended tile, the last one the tile alone
  for (int s = 0; s < n_sweeps; ++s) {
    for (int color = 0; color < 2; ++color) {
      uint32_t* tgt = color ? s_w : s_b;
      const uint32_t* op = color ? s_b : s_w;
      // half_sweep_offset(start, s, color), uint32 wrap
      const uint32_t offset = start + 2u * static_cast<uint32_t>(s) +
                              static_cast<uint32_t>(color);
      const int margin = 2 * s + color + 1;
      const int iw = ec - 2 * margin;
      const int cells = (er - 2 * margin) * iw;
      for (int x = tid; x < cells; x += nthreads) {
        const int i = margin + x / iw;
        const int j = margin + x % iw;
        // the extended plane's own row parity
        const bool plus = ((s_row[i] & 1) != 0) == (color == 0);
        const int c = i * ec + j;
        const uint32_t center = op[c];
        const uint32_t nn = op[c - ec] + op[c + ec] + center +
                            side_word(center, op[plus ? c + 1 : c - 1], plus);
        tgt[c] = update_word(tgt[c], nn, s_g[c], offset, k0, k1, s_thr);
      }
      __syncthreads();
    }
  }

  const int rows = min(tile_r, n - static_cast<int>(blockIdx.y) * tile_r);
  const int cols = min(tile_c, w - static_cast<int>(blockIdx.x) * tile_c);
  for (int x = tid; x < rows * cols; x += nthreads) {
    const int i = x / cols;
    const int j = x % cols;
    const int c = (i + halo) * ec + j + halo;
    const size_t g = static_cast<size_t>(blockIdx.y * tile_r + i) * w +
                     blockIdx.x * tile_c + j;
    b_out[g] = s_b[c];
    w_out[g] = s_w[c];
  }
}

}  // namespace

extern "C" {

int multispin_update_launch(void* target, const void* op, int n, int w,
                            int is_black, const uint32_t* thr, uint32_t k0,
                            uint32_t k1, uint32_t offset, void* stream) {
  const int threads = w >= 256 ? 256 : ((w + 31) / 32) * 32;
  const dim3 grid(n, (w + threads - 1) / threads);
  multispin_update_kernel<<<grid, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(target), static_cast<const uint32_t*>(op), n, w,
      is_black, make_thresholds(thr), k0, k1, offset);
  return static_cast<int>(cudaGetLastError());
}

long long multispin_resident_smem_bytes(int tile_r, int tile_c,
                                        int n_sweeps) {
  return static_cast<long long>(resident_smem_bytes(tile_r, tile_c, n_sweeps));
}

int multispin_sweeps_resident_launch(const void* b_in, const void* w_in,
                                     void* b_out, void* w_out, int n, int w,
                                     const uint32_t* thr, uint32_t k0,
                                     uint32_t k1, uint32_t start,
                                     int n_sweeps, int tile_r, int tile_c,
                                     int threads, void* stream) {
  const size_t smem = resident_smem_bytes(tile_r, tile_c, n_sweeps);
  cudaError_t err = cudaFuncSetAttribute(
      multispin_sweeps_resident_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch would report it
    return static_cast<int>(err);
  }
  const dim3 grid((w + tile_c - 1) / tile_c, (n + tile_r - 1) / tile_r);
  multispin_sweeps_resident_kernel<<<grid, threads, smem,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(b_in), static_cast<const uint32_t*>(w_in),
      static_cast<uint32_t*>(b_out), static_cast<uint32_t*>(w_out), n, w,
      make_thresholds(thr), k0, k1, start, n_sweeps, tile_r, tile_c);
  return static_cast<int>(cudaGetLastError());
}

long long multispin_shard_smem_bytes(int tile_r, int tile_c, int n_sweeps) {
  return static_cast<long long>(shard_smem_bytes(tile_r, tile_c, n_sweeps));
}

int multispin_shard_sweeps_launch(const void* b_in, const void* w_in,
                                  const void* widx, void* b_out, void* w_out,
                                  int n, int w, const uint32_t* thr,
                                  uint32_t k0, uint32_t k1, uint32_t start,
                                  int n_sweeps, int tile_r, int tile_c,
                                  int threads, void* stream) {
  const size_t smem = shard_smem_bytes(tile_r, tile_c, n_sweeps);
  cudaError_t err = cudaFuncSetAttribute(
      multispin_shard_sweeps_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch would report it
    return static_cast<int>(err);
  }
  const dim3 grid((w + tile_c - 1) / tile_c, (n + tile_r - 1) / tile_r);
  multispin_shard_sweeps_kernel<<<grid, threads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(b_in), static_cast<const uint32_t*>(w_in),
      static_cast<const uint32_t*>(widx), static_cast<uint32_t*>(b_out),
      static_cast<uint32_t*>(w_out), n, w, make_thresholds(thr), k0, k1, start,
      n_sweeps, tile_r, tile_c);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
