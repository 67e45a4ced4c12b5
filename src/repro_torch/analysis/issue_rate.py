"""Issue rates of the Philox arithmetic on the card, in SM clocks.

    PYTHONPATH=src python -m repro_torch.analysis.issue_rate

Builds one small CUDA program with nvcc (into ``kernels/_build``'s
directory) and times, with CUDA events at the card's maximum SM clock:
Philox4x32-10 with the offset's work hoisted (``csrc/philox_lane0.cuh``,
``HoistedPhilox``) as the kernels draw it -- lane 0 (the stencil
kernels), lanes 0 and 1 (``tensorcore_update``, also with its key's
second word 0 as the kernel keys it) and all four lanes (the bitplane
shard kernel's aligned groups) -- the two calls of a multispin word as
``HoistedPhiloxPair`` draws them (its key schedule a kernel parameter,
as the multispin k-sweep and shard kernels take it; the 8 lanes folded
by XOR), the multispin k-sweep kernels' accept alone (on draws of one
multiply-add each) and behind the paired Philox, and lane 0 as the
general ``philox4x32_10`` gives it, 4 calls (or words) a thread and
step with no memory traffic but the accept's table (SM clocks a call or
word: the floor of a kernel that draws once a site, position, group or
word); and chains of 32x32
products, 16 independent chains a thread, whose rate bounds a multiply's
throughput from below (products per SM clock): the wide multiply
(``IMAD.WIDE.U32``, both halves), the high half alone (``IMAD.HI.U32``)
and the low half alone (``IMAD``), each with one shift or XOR a step,
and the shift and XOR alone.  The yardstick in ``chip_smoke.py``
(``PIPE_OPS``, ``FMA_WIDE_SLOTS``) counts a wide multiply as two of 64
FMA-pipe slots a clock from these rates.  The last lines are the card's
name and power limit.
"""
from __future__ import annotations

import re
import subprocess
import sys

from repro_torch.kernels import _build

SOURCE = r"""
#include <cstdio>
#include <cstdlib>
#include <cstdint>
#include <cuda_runtime.h>
#include "philox_lane0.cuh"
using namespace repro_torch;

// lanes 1: lane 0; 2: lanes 0 and 1; 4: all four.  zero_key1: the key's
// second word a literal 0, as tensorcore.cu keys it
template <int lanes, bool zero_key1>
__global__ void hoisted(uint32_t* out, int iters, uint32_t off, uint32_t k0,
                        uint32_t k1) {
  const HoistedPhilox ph(off, k0, zero_key1 ? 0u : k1);
  uint32_t acc = 0;
  uint32_t s = (blockIdx.x * blockDim.x + threadIdx.x) * 4;
#pragma unroll 1
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (lanes == 1) acc += ph(s + e) >> 31;
      if (lanes == 2) {
        const uint2 d = ph.lanes01(s + e);
        acc += (d.x >> 31) + (d.y >> 31);
      }
      if (lanes == 4) {
        const uint4 d = ph.lanes(s + e);
        acc += (d.x >> 31) + (d.y >> 31) + (d.z >> 31) + (d.w >> 31);
      }
    }
    s += 0x10000;
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

// the two calls of a multispin word, counters c and c + 1; kAccept: the
// multispin k-sweep kernels' accept on the 8 draws (a key word of
// nibbles s * 8 + c, here made from the word index, one shared-memory
// table load, compare and merge a nibble), kDraws false: the accept on
// draws of one multiply-add each instead of Philox
template <bool kDraws, bool kAccept>
__global__ void hoisted_pair(uint32_t* out, int iters, uint32_t counter,
                             PhiloxKeys keys) {
  __shared__ uint32_t s_table[16];
  if (threadIdx.x < 16) s_table[threadIdx.x] = 0x0F0F0F0Fu * threadIdx.x;
  __syncthreads();
  const unsigned char* table = reinterpret_cast<const unsigned char*>(s_table);
  const HoistedPhiloxPair ph(counter, keys);
  uint32_t acc = 0;
  uint32_t s = (blockIdx.x * blockDim.x + threadIdx.x) * 4;
#pragma unroll 1
  for (int i = 0; i < iters; ++i) {
#pragma unroll 1
    for (int e = 0; e < 4; ++e) {
      uint32_t d[8];
      if (kDraws) {
        ph(s + e, d);
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) d[q] = (s + e) * 0x9E3779B9u + q;
      }
      if (!kAccept) {
        acc ^= d[0] ^ d[1] ^ d[2] ^ d[3] ^ d[4] ^ d[5] ^ d[6] ^ d[7];
        continue;
      }
      const uint32_t key = ((s + e) & 0x33333333u) | ((acc & 0x11111111u) << 3);
      const uint32_t even = (key << 2) & 0x3C3C3C3Cu;
      const uint32_t odd = (key >> 2) & 0x3C3C3C3Cu;
      uint32_t flip = 0;
#pragma unroll
      for (int nib = 0; nib < 8; ++nib) {
        const uint32_t at =
            __byte_perm(nib & 1 ? odd : even, 0u, 0x4440u | (nib >> 1));
        if (d[nib] < *reinterpret_cast<const uint32_t*>(table + at)) {
          flip |= 1u << (4 * nib);
        }
      }
      acc ^= flip;
    }
    s += 0x10000;
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

__global__ void general(uint32_t* out, int iters, uint32_t off, uint32_t k0,
                        uint32_t k1) {
  uint32_t acc = 0;
  uint32_t s = (blockIdx.x * blockDim.x + threadIdx.x) * 4;
#pragma unroll 1
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc += philox4x32_10(make_uint4(off, 0, s + e, 0), k0, k1).x >> 31;
    }
    s += 0x10000;
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

template <int kind>
__global__ void chain(uint32_t* out, int iters) {
  uint32_t x[16];
  for (int i = 0; i < 16; ++i) x[i] = threadIdx.x * 16 + i + blockIdx.x * 977;
#pragma unroll 1
  for (int s = 0; s < iters; ++s) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (kind == 0) {
        const uint64_t p = static_cast<uint64_t>(x[i]) * kPhiloxM0;
        x[i] = static_cast<uint32_t>(p >> 32) ^ static_cast<uint32_t>(p);
      }
      if (kind == 1) {
        uint32_t h;
        asm volatile("mul.hi.u32 %0, %1, %2;" : "=r"(h) : "r"(x[i]),
                     "r"(kPhiloxM0));
        x[i] = h ^ (x[i] >> 3);
      }
      if (kind == 2) {
        uint32_t l;
        asm volatile("mul.lo.u32 %0, %1, %2;" : "=r"(l) : "r"(x[i]),
                     "r"(kPhiloxM0));
        x[i] = l ^ (x[i] >> 3);
      }
      if (kind == 3) x[i] = (x[i] ^ 0x9E3779B9u) ^ (x[i] >> 3);
    }
  }
  uint32_t r = 0;
  for (int i = 0; i < 16; ++i) r ^= x[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = r;
}

template <class F>
void timeit(const char* name, const char* unit, F launch, double items,
            double clocks_per_ms) {
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  launch();
  cudaDeviceSynchronize();
  cudaEventRecord(a);
  launch();
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  const double clocks = ms * clocks_per_ms;
  printf("%s: %.4f ms, %.4f SM clocks a %s, %.2f %ss per SM clock\n", name,
         ms, clocks / items, unit, items / clocks, unit);
}

int main(int argc, char** argv) {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const double mhz = atof(argv[1]);
  const double clocks_per_ms = mhz * 1e3 * sms;
  const int blocks = sms * 8, threads = 256, iters = 2048;
  uint32_t* out;
  cudaMalloc(&out, blocks * threads * 4);
  const double sites = 4.0 * blocks * threads * iters;
  timeit("lane-0 Philox (philox_lane0.cuh)", "site",
         [&] {
           hoisted<1, false><<<blocks, threads>>>(out, iters, 7, 11, 13);
         },
         sites, clocks_per_ms);
  timeit("lanes 0-1 of hoisted Philox", "call",
         [&] {
           hoisted<2, false><<<blocks, threads>>>(out, iters, 7, 11, 13);
         },
         sites, clocks_per_ms);
  timeit("lanes 0-1 of hoisted Philox, key (k0, 0)", "call",
         [&] {
           hoisted<2, true><<<blocks, threads>>>(out, iters, 7, 11, 13);
         },
         sites, clocks_per_ms);
  timeit("lanes 0-3 of hoisted Philox", "call",
         [&] {
           hoisted<4, false><<<blocks, threads>>>(out, iters, 7, 11, 13);
         },
         sites, clocks_per_ms);
  timeit("paired hoisted Philox (HoistedPhiloxPair), 8 lanes", "word",
         [&] {
           hoisted_pair<true, false><<<blocks, threads>>>(
               out, iters, 14, PhiloxKeys(11, 13));
         },
         sites, clocks_per_ms);
  printf("  (the yardstick: 34 wide multiplies a word at 2 of 64 FMA-pipe "
         "slots each, 1.0625 SM clocks a word)\n");
  timeit("the multispin accept on cheap draws", "word",
         [&] {
           hoisted_pair<false, true><<<blocks, threads>>>(
               out, iters, 14, PhiloxKeys(11, 13));
         },
         sites, clocks_per_ms);
  timeit("paired hoisted Philox and the multispin accept", "word",
         [&] {
           hoisted_pair<true, true><<<blocks, threads>>>(
               out, iters, 14, PhiloxKeys(11, 13));
         },
         sites, clocks_per_ms);
  timeit("philox4x32_10, lane 0", "site",
         [&] { general<<<blocks, threads>>>(out, iters, 7, 11, 13); }, sites,
         clocks_per_ms);
  const double steps = 16.0 * blocks * threads * iters;
  timeit("wide multiply + XOR chains", "product",
         [&] { chain<0><<<blocks, threads>>>(out, iters); }, steps,
         clocks_per_ms);
  timeit("high-half multiply + shift/XOR chains", "product",
         [&] { chain<1><<<blocks, threads>>>(out, iters); }, steps,
         clocks_per_ms);
  timeit("low-half multiply + shift/XOR chains", "product",
         [&] { chain<2><<<blocks, threads>>>(out, iters); }, steps,
         clocks_per_ms);
  timeit("shift/XOR chains", "step",
         [&] { chain<3><<<blocks, threads>>>(out, iters); }, steps,
         clocks_per_ms);
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
"""


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip() \
        .splitlines()[0]


def main(argv=None) -> int:
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "issue_rate.cu"
    exe = _build.BUILD_DIR / "issue_rate"
    src.write_text(SOURCE)
    subprocess.run([_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-I", str(_build.CSRC_DIR), "-o",
                    str(exe), str(src)], check=True)
    mhz = re.match(r"[\d.]+", nvidia_smi("clocks.max.sm")).group(0)
    out = subprocess.run([str(exe), mhz], check=True, capture_output=True,
                         text=True).stdout
    print(f"at the maximum SM clock, {mhz} MHz:")
    print(out, end="")
    print(nvidia_smi("name,power.limit"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
