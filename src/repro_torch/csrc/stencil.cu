// Checkerboard Metropolis on int8 compact colour planes, for Hopper (sm_90a).
//
// Three kernels with a plain C interface (loaded with ctypes by
// repro_torch.kernels.stencil and repro_torch.dist.kernels):
//
// * stencil_update: one colour half-sweep.  Replaces the Pallas kernel
//   src/repro/kernels/stencil/stencil.py:stencil_update.  One thread per
//   target site reads its own target spin and its four neighbours in the
//   opposite plane (periodic wrap, side tap by global row parity), draws
//   lane 0 of Philox4x32-10 at counter (offset, 0, row*h + col, 0) and
//   flips iff u < table[s, nn].  Each thread reads only its own target
//   site, so the target plane is updated in place.
//   Bound: the Philox rounds (integer multiplies and XORs), not bytes:
//   a site moves 3 bytes but costs some 40 integer instructions.  The
//   design keeps every thread independent (no shared memory, no
//   barriers) so that all warps can run Philox arithmetic.
//
// * stencil_sweeps_resident: n_sweeps full sweeps in one launch.
//   Replaces src/repro/kernels/stencil/resident.py:stencil_sweeps_resident,
//   which holds both whole planes in TPU VMEM.  A block has at most
//   227 KB of shared memory, so this kernel blocks in time on tiles
//   instead: each block loads a tile of both planes plus a halo of
//   width 2 * n_sweeps (rows and compact columns, wrapped modulo n and
//   h), runs 2 * n_sweeps half-sweeps on the extended tile with a
//   barrier between them, and writes back only the tile.  A cell at
//   distance d from the extended tile's edge is exact for d half-sweeps,
//   and every draw is keyed on the site's global (row, col), so the tile
//   is bit for bit what whole-lattice sweeps give.  Input and output
//   planes must differ: neighbouring blocks read each other's tiles.
//   Bound: Philox arithmetic as above, plus the halo's redundant draws;
//   global memory is touched once per launch.
//
// * stencil_shard_sweeps: n_sweeps full sweeps of one halo-extended shard
//   of a sharded run.  Replaces src/repro/dist/kernels.py:
//   stencil_shard_sweeps, which holds the whole extended shard in TPU
//   VMEM and updates all of it with wrap taps, keying each site's draw on
//   a plane of uint32 global site indices (gidx) and taking the row
//   parity from the extended plane's own row index.  Here the temporal
//   blocking of stencil_sweeps_resident runs on the extended plane as if
//   it were a lattice (tiles wrap over its own dims), with the key read
//   from gidx: each block stages its extended tile of gidx in shared
//   memory with the planes (6 bytes per cell), and each half-sweep
//   updates one ring less of the extended tile than the last.  The
//   result equals the TPU kernel's on the whole extended plane, its edge
//   rings included.  Input and output planes must differ.
//   Bound: Philox arithmetic as above; the gidx plane adds 4 bytes per
//   cell to the bytes read once per launch.
//
// The accept is a lookup in a 10-entry float32 table passed by value
// (index (s > 0) * 5 + (nn + 4) / 2), never expf: the table is built
// once on the host so that the card, the CPU and the reference agree.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "common.cuh"
#include "philox.cuh"

namespace {

using repro_torch::wrap;

constexpr int kTableSize = 10;

struct AcceptTable {
  float v[kTableSize];
};

__device__ __forceinline__ int8_t metropolis_site(int8_t t, int nn,
                                                  uint32_t site,
                                                  uint32_t offset,
                                                  uint32_t k0, uint32_t k1,
                                                  const float* table) {
  const uint4 r =
      repro_torch::philox4x32_10(make_uint4(offset, 0u, site, 0u), k0, k1);
  const float u = repro_torch::u32_to_uniform(r.x);
  const int index = (t > 0 ? 5 : 0) + ((nn + 4) >> 1);
  return u < table[index] ? static_cast<int8_t>(-t) : t;
}

__device__ __forceinline__ void load_table(const AcceptTable& tab,
                                           float* s_table, int tid) {
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kTableSize; ++i) s_table[i] = tab.v[i];
  }
}

// grid (n, ceil(h / blockDim.x)): blockIdx.x is the row
__global__ void stencil_update_kernel(int8_t* __restrict__ target,
                                      const int8_t* __restrict__ op, int n,
                                      int h, int is_black, AcceptTable tab,
                                      uint32_t k0, uint32_t k1,
                                      uint32_t offset) {
  __shared__ float s_table[kTableSize];
  load_table(tab, s_table, threadIdx.x);
  __syncthreads();
  const int row = blockIdx.x;
  const int col = blockIdx.y * blockDim.x + threadIdx.x;
  if (col >= h) return;
  const int up = row == 0 ? n - 1 : row - 1;
  const int down = row == n - 1 ? 0 : row + 1;
  // black targets take (i, k+1) on odd rows, (i, k-1) on even; white the
  // reverse
  const bool plus = ((row & 1) != 0) == (is_black != 0);
  const int side = plus ? (col == h - 1 ? 0 : col + 1)
                        : (col == 0 ? h - 1 : col - 1);
  const size_t base = static_cast<size_t>(row) * h;
  const int nn = op[static_cast<size_t>(up) * h + col] +
                 op[static_cast<size_t>(down) * h + col] + op[base + col] +
                 op[base + side];
  const uint32_t site =
      static_cast<uint32_t>(row) * static_cast<uint32_t>(h) +
      static_cast<uint32_t>(col);
  target[base + col] =
      metropolis_site(target[base + col], nn, site, offset, k0, k1, s_table);
}

// Shared memory of one block: global row and column indices of the
// extended tile, the table, then both extended planes.
__host__ __device__ inline size_t resident_smem_bytes(int tile_r, int tile_c,
                                                      int n_sweeps) {
  const size_t er = tile_r + 4 * n_sweeps;
  const size_t ec = tile_c + 4 * n_sweeps;
  return 4 * (er + ec) + 4 * 16 + 2 * er * ec;
}

// grid (ceil(h / tile_c), ceil(n / tile_r)), block (32, 16)
__global__ void stencil_sweeps_resident_kernel(
    const int8_t* __restrict__ b_in, const int8_t* __restrict__ w_in,
    int8_t* __restrict__ b_out, int8_t* __restrict__ w_out, int n, int h,
    AcceptTable tab, uint32_t k0, uint32_t k1, uint32_t start, int n_sweeps,
    int tile_r, int tile_c) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int halo = 2 * n_sweeps;
  const int er = tile_r + 2 * halo;
  const int ec = tile_c + 2 * halo;
  int* s_row = reinterpret_cast<int*>(smem);
  int* s_col = s_row + er;
  float* s_table = reinterpret_cast<float*>(s_col + ec);
  int8_t* s_b = reinterpret_cast<int8_t*>(s_table + 16);
  int8_t* s_w = s_b + static_cast<size_t>(er) * ec;

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int r0 = blockIdx.y * tile_r - halo;
  const int c0 = blockIdx.x * tile_c - halo;
  for (int i = tid; i < er; i += nthreads) s_row[i] = wrap(r0 + i, n);
  for (int j = tid; j < ec; j += nthreads) s_col[j] = wrap(c0 + j, h);
  load_table(tab, s_table, tid);
  __syncthreads();

  for (int i = threadIdx.y; i < er; i += blockDim.y) {
    const size_t g = static_cast<size_t>(s_row[i]) * h;
    for (int j = threadIdx.x; j < ec; j += blockDim.x) {
      s_b[i * ec + j] = b_in[g + s_col[j]];
      s_w[i * ec + j] = w_in[g + s_col[j]];
    }
  }
  __syncthreads();

  for (int s = 0; s < n_sweeps; ++s) {
    for (int color = 0; color < 2; ++color) {
      int8_t* tgt = color ? s_w : s_b;
      const int8_t* op = color ? s_b : s_w;
      // half_sweep_offset(start, s, color), uint32 wrap
      const uint32_t offset = start + 2u * static_cast<uint32_t>(s) +
                              static_cast<uint32_t>(color);
      // the outermost ring lacks neighbours: it stays stale, which the
      // halo absorbs
      for (int i = 1 + threadIdx.y; i < er - 1; i += blockDim.y) {
        const bool plus = ((s_row[i] & 1) != 0) == (color == 0);
        const int dj = plus ? 1 : -1;
        const uint32_t row_base =
            static_cast<uint32_t>(s_row[i]) * static_cast<uint32_t>(h);
        for (int j = 1 + threadIdx.x; j < ec - 1; j += blockDim.x) {
          const int c = i * ec + j;
          const int nn = op[c - ec] + op[c + ec] + op[c] + op[c + dj];
          tgt[c] = metropolis_site(tgt[c], nn,
                                   row_base + static_cast<uint32_t>(s_col[j]),
                                   offset, k0, k1, s_table);
        }
      }
      __syncthreads();
    }
  }

  for (int i = threadIdx.y; i < tile_r; i += blockDim.y) {
    const int gr = blockIdx.y * tile_r + i;
    if (gr >= n) break;
    for (int j = threadIdx.x; j < tile_c; j += blockDim.x) {
      const int gc = blockIdx.x * tile_c + j;
      if (gc >= h) break;
      const int c = (i + halo) * ec + j + halo;
      const size_t g = static_cast<size_t>(gr) * h + gc;
      b_out[g] = s_b[c];
      w_out[g] = s_w[c];
    }
  }
}

// Shared memory of one shard-kernel block: row and column indices of the
// extended tile, the table, the tile's site indices, then both planes.
__host__ __device__ inline size_t shard_smem_bytes(int tile_r, int tile_c,
                                                   int n_sweeps) {
  const size_t er = tile_r + 4 * n_sweeps;
  const size_t ec = tile_c + 4 * n_sweeps;
  return 4 * (er + ec) + 4 * 16 + 6 * er * ec;
}

// grid (ceil(w / tile_c), ceil(n / tile_r)), 1-D blocks; n x w is the
// extended shard
__global__ void stencil_shard_sweeps_kernel(
    const int8_t* __restrict__ b_in, const int8_t* __restrict__ w_in,
    const uint32_t* __restrict__ gidx, int8_t* __restrict__ b_out,
    int8_t* __restrict__ w_out, int n, int w, AcceptTable tab, uint32_t k0,
    uint32_t k1, uint32_t start, int n_sweeps, int tile_r, int tile_c) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int halo = 2 * n_sweeps;
  const int er = tile_r + 2 * halo;
  const int ec = tile_c + 2 * halo;
  int* s_row = reinterpret_cast<int*>(smem);
  int* s_col = s_row + er;
  float* s_table = reinterpret_cast<float*>(s_col + ec);
  uint32_t* s_g = reinterpret_cast<uint32_t*>(s_table + 16);
  int8_t* s_b = reinterpret_cast<int8_t*>(s_g + static_cast<size_t>(er) * ec);
  int8_t* s_w = s_b + static_cast<size_t>(er) * ec;

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int r0 = blockIdx.y * tile_r - halo;
  const int c0 = blockIdx.x * tile_c - halo;
  for (int i = tid; i < er; i += nthreads) s_row[i] = wrap(r0 + i, n);
  for (int j = tid; j < ec; j += nthreads) s_col[j] = wrap(c0 + j, w);
  load_table(tab, s_table, tid);
  __syncthreads();

  for (int c = tid; c < er * ec; c += nthreads) {
    const size_t g = static_cast<size_t>(s_row[c / ec]) * w + s_col[c % ec];
    s_b[c] = b_in[g];
    s_w[c] = w_in[g];
    s_g[c] = gidx[g];
  }
  __syncthreads();

  // half-sweep q (from 0) updates the cells at distance >= q + 1 from the
  // edge of the extended tile, the last one the tile alone (as in
  // multispin_sweeps_resident_kernel)
  for (int s = 0; s < n_sweeps; ++s) {
    for (int color = 0; color < 2; ++color) {
      int8_t* tgt = color ? s_w : s_b;
      const int8_t* op = color ? s_b : s_w;
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
        const int nn =
            op[c - ec] + op[c + ec] + op[c] + op[plus ? c + 1 : c - 1];
        tgt[c] = metropolis_site(tgt[c], nn, s_g[c], offset, k0, k1, s_table);
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

AcceptTable make_table(const float* table) {
  AcceptTable tab;
  std::memcpy(tab.v, table, sizeof(tab.v));
  return tab;
}

}  // namespace

extern "C" {

int stencil_update_launch(void* target, const void* op, int n, int h,
                          int is_black, const float* table, uint32_t k0,
                          uint32_t k1, uint32_t offset, void* stream) {
  const int threads = h >= 256 ? 256 : ((h + 31) / 32) * 32;
  const dim3 grid(n, (h + threads - 1) / threads);
  stencil_update_kernel<<<grid, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(target), static_cast<const int8_t*>(op), n, h,
      is_black, make_table(table), k0, k1, offset);
  return static_cast<int>(cudaGetLastError());
}

long long stencil_resident_smem_bytes(int tile_r, int tile_c, int n_sweeps) {
  return static_cast<long long>(resident_smem_bytes(tile_r, tile_c, n_sweeps));
}

int stencil_sweeps_resident_launch(const void* b_in, const void* w_in,
                                   void* b_out, void* w_out, int n, int h,
                                   const float* table, uint32_t k0,
                                   uint32_t k1, uint32_t start, int n_sweeps,
                                   int tile_r, int tile_c, void* stream) {
  const size_t smem = resident_smem_bytes(tile_r, tile_c, n_sweeps);
  cudaError_t err = cudaFuncSetAttribute(
      stencil_sweeps_resident_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch would report it
    return static_cast<int>(err);
  }
  const dim3 block(32, 16);
  const dim3 grid((h + tile_c - 1) / tile_c, (n + tile_r - 1) / tile_r);
  stencil_sweeps_resident_kernel<<<grid, block, smem,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(b_in), static_cast<const int8_t*>(w_in),
      static_cast<int8_t*>(b_out), static_cast<int8_t*>(w_out), n, h,
      make_table(table), k0, k1, start, n_sweeps, tile_r, tile_c);
  return static_cast<int>(cudaGetLastError());
}

long long stencil_shard_smem_bytes(int tile_r, int tile_c, int n_sweeps) {
  return static_cast<long long>(shard_smem_bytes(tile_r, tile_c, n_sweeps));
}

int stencil_shard_sweeps_launch(const void* b_in, const void* w_in,
                                const void* gidx, void* b_out, void* w_out,
                                int n, int w, const float* table, uint32_t k0,
                                uint32_t k1, uint32_t start, int n_sweeps,
                                int tile_r, int tile_c, int threads,
                                void* stream) {
  const size_t smem = shard_smem_bytes(tile_r, tile_c, n_sweeps);
  cudaError_t err = cudaFuncSetAttribute(
      stencil_shard_sweeps_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch would report it
    return static_cast<int>(err);
  }
  const dim3 grid((w + tile_c - 1) / tile_c, (n + tile_r - 1) / tile_r);
  stencil_shard_sweeps_kernel<<<grid, threads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(b_in), static_cast<const int8_t*>(w_in),
      static_cast<const uint32_t*>(gidx), static_cast<int8_t*>(b_out),
      static_cast<int8_t*>(w_out), n, w, make_table(table), k0, k1, start,
      n_sweeps, tile_r, tile_c);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
