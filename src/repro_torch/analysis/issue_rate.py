"""Issue rates of the Philox arithmetic on the card, in SM clocks.

    PYTHONPATH=src python -m repro_torch.analysis.issue_rate

Builds one small CUDA program with nvcc (into ``kernels/_build``'s
directory) and times, with CUDA events at the card's maximum SM clock:
Philox4x32-10 with the offset's work hoisted (``csrc/philox_lane0.cuh``,
``HoistedPhilox``) as the kernels draw it -- lane 0 (the stencil
kernels), lanes 0 and 1 (``tensorcore_update``, also with its key's
second word 0 as the kernel keys it) and all four lanes (the bitplane
shard kernel's aligned groups) -- and lane 0 as the general
``philox4x32_10`` gives it, 4 calls a thread and step with no memory
traffic (SM clocks a call: the floor of a kernel that draws once a
site, position or group); and chains of 32x32
products, 16 independent chains a thread, whose rate bounds a multiply's
throughput from below (products per SM clock): the wide multiply
(``IMAD.WIDE.U32``, both halves), the high half alone (``IMAD.HI.U32``)
and the low half alone (``IMAD``), each with one shift or XOR a step,
and the shift and XOR alone.  The yardstick in ``chip_smoke.py``
(``PIPE_OPS``, ``FMA_SLOTS``) counts a wide multiply as two of 64
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
