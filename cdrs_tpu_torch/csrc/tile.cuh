// Pieces shared by the port's kernels (sm_90a): staging warp tiles of x
// into shared memory with cp.async, the one-launch finalize (a ticket taken
// by the last block, which then sums the block partials in a fixed order),
// and the once-per-device launch attributes.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace cdrs {

constexpr int kStages = 3;   // tiles in flight per warp

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// A warp tile: 32 rows of D elements of T, one row per lane.  Its byte size
// is a multiple of 16, so every tile of a 16-byte aligned x starts 16-byte
// aligned even where a row (20 bytes at d = 5) does not.
template <typename T, int D>
struct WarpTile {
  static constexpr int ROWS = 32;
  static constexpr int BYTES = ROWS * D * (int)sizeof(T);
  static_assert(BYTES % 16 == 0, "a tile must be a whole number of 16-byte chunks");
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
// 8- and 4-byte copies (through L1: .cg takes only 16 bytes).
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// cp_async_wait<n> for a count known only at run time (0 <= n <= 7).
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// Starts the copy of `bytes` bytes at `src` into `dst` by the lanes of one
// warp: 16-byte cp.async chunks (the last one reads only what is left and
// zero-fills the rest) when x is 16-byte aligned, else plain 2-byte loads
// (elements are at least 2 bytes wide), which complete at once.  The warp
// reads the tile after cp_async_wait and __syncwarp.
__device__ __forceinline__ void stage_warp_tile(unsigned char* dst, const unsigned char* src,
                                                int bytes, bool aligned) {
  const int lane = threadIdx.x & 31;
  if (aligned) {
    for (int off = lane << 4; off < bytes; off += 32 << 4) {
      const int rem = bytes - off;
      cp_async16(dst + off, src + off, rem < 16 ? rem : 16);
    }
  } else {
    for (int q = lane; q < (bytes >> 1); q += 32)
      ((uint16_t*)dst)[q] = ((const uint16_t*)src)[q];
  }
}

// In the last block: out(e, sum over b of part[e * nblocks + b]) for every
// cell e < cells.  The partials pass through shared memory `stage` (room
// for `cap` >= nblocks values) in chunks of whole cells: every thread
// loads its share at once (coalesced, all loads in flight), then a warp
// sums a cell, lane l adding blocks l, l + 32, ... in order before a fixed
// shuffle tree.  Fixed order, so the same inputs give the same bits.
template <typename V, typename Out>
__device__ __forceinline__ void sum_block_partials(const V* part, int cells, int nblocks,
                                                   V* stage, int cap, Out out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int per = cap / nblocks;
  for (int e0 = 0; e0 < cells; e0 += per) {
    const int ec = cells - e0 < per ? cells - e0 : per;
    const int total = ec * nblocks;
    const V* src = part + (int64_t)e0 * nblocks;
#pragma unroll 4
    for (int p = threadIdx.x; p < total; p += blockDim.x) stage[p] = __ldcg(src + p);
    __syncthreads();
    for (int e = warp; e < ec; e += warps) {
      V s = 0;
      for (int b = lane; b < nblocks; b += 32) s += stage[e * nblocks + b];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
      if (lane == 0) out(e0 + e, s);
    }
    __syncthreads();
  }
}

// Called by every thread of every block after it wrote its partials.
// Returns true in the last block to take a ticket, which then sums the
// partials and sets the ticket back to zero for the next launch.
__device__ __forceinline__ bool last_block(unsigned* ticket) {
  __shared__ bool s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (s_last) __threadfence();
  return s_last;
}

// Raises a kernel's dynamic shared-memory limit to `smem` once per device
// (and again only for a larger size), not once per launch.  `done` is the
// instantiation's own record of the limit set on each device.
template <typename Kernel>
cudaError_t set_smem_once(Kernel kern, size_t smem, size_t (&done)[32]) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && done[dev] >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && dev < 32) done[dev] = smem;
  return err;
}

// Resident blocks per SM of a kernel at its launch shape, asked once per
// instantiation (`cached` is 0 until then).
template <typename Kernel>
cudaError_t blocks_per_sm_once(Kernel kern, int threads, size_t smem, int& cached) {
  if (cached > 0) return cudaSuccess;
  int blocks = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, threads, smem);
  if (err != cudaSuccess) return err;
  cached = blocks > 0 ? blocks : 1;
  return cudaSuccess;
}

}  // namespace cdrs
