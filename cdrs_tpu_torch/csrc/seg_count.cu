// Threshold counts for the bisection medians, on Hopper (sm_90a), per
// cluster and globally in one pass over x:
//
//   out[j, r*d + f] = #{ i : labels_i = j  and  x[i, f] <= thr[r, j, f] }
//   gout[r, f]      = #{ i : labels_i in [0, k)  and  x[i, f] <= gthr[r, f] }
//
// for r in {0, 1} (the two middle ranks bisected together); labels < 0 or
// >= k mean "no cluster".  gout is optional (gthr NULL).
//
// Replaces the TPU kernel label_segment_matmul (cdrs_tpu/ops/pallas_kernels.py,
// _kernel_seg / _build_seg) applied to the 0/1 matrix y its only caller
// builds (cdrs_tpu/ops/scoring_jax.py, _bisect_core), together with the
// global-rank count that the caller's chunk pass takes beside it: there the
// threshold gather, the compare and a bf16 y of width 2d are materialised
// per chunk and reduced by a one-hot matmul on the MXU.  Here the gather and
// the compares are fused into one counting pass, so y never exists, and
// counts are integers: exact, and independent of the order of the adds.
//
// What bounds it on this card: x and the labels are read once and each
// element is compared four times, so the pass is memory bound.  The cost
// beyond the read is the counting.
//
// * Small path (d <= 8, k <= 32: the pipeline's d = 5, k = 8).  Each warp
//   walks its own 32-row tiles of x (warp w takes tiles w, w + all warps,
//   ...), staged in shared memory by 16-byte cp.async copies, three tiles
//   in flight per warp and no block-wide barrier in the loop; thresholds
//   sit in shared memory, the global ones in registers.  A lane owns a row
//   and loads its label once.  Lane j also owns cluster j's 2d counters:
//   per tile it takes the mask of the rows of cluster j from one validity
//   ballot and one ballot per label bit, and for each (rank, feature) one
//   ballot of the rows' compares against their own cluster's threshold,
//   adding __popc(compare & mask).  The global compares are counted per
//   thread.  All counters are registers, with no atomics in the loop.
//   Blocks add their lanes into shared memory (integers: exact in any
//   order) and write a partial; the last block to take a ticket sums the
//   partials and writes the tables, so the output needs no zeroing and the
//   call is one launch.
// * General path (the 1M x 128, k = 1024 shape).  A warp per row, lanes over
//   its features: a row's label is loaded once and the lanes of a warp add
//   to distinct counters of a shared-memory histogram (global memory when
//   16*k*d bytes exceed 192 KB); the global counters are always in shared
//   memory.  Both are flushed by integer atomics into the output, zeroed
//   first.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tile.cuh"

namespace {

using cdrs::kStages;
using cdrs::to_f;

constexpr int kGenThreads = 256;
constexpr size_t kSmemBudget = 192 * 1024;

struct Args {
  const void* x;
  const int* labels;
  const float* thr;    // (2, k, d)
  const float* gthr;   // (2, d) or NULL
  int64_t n;
  int d, k;
  int* out;            // (k*2d [+ 2d]) : per-cluster table, then the global one
  int* part;           // (C, grid) block partials (small path)
  unsigned* ticket;    // zero between launches
  int nb;              // partial capacity (blocks)
  int sms;
  cudaStream_t stream;
};

// ---------------------------------------------------------------- small path

template <int D>
struct Small {
  // One block per SM: 1024 threads capped at 64 registers (32 warps per
  // SM) up to d = 5, 512 threads with more registers beyond.
  static constexpr int THREADS = D <= 5 ? 1024 : 512;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int KMAX = 32;
  static constexpr int CMAX = KMAX * 2 * D + 2 * D;   // counters at most
};

template <typename T, int D>
__global__ void __launch_bounds__(Small<D>::THREADS, 1)
seg_small_kernel(const T* __restrict__ x, const int* __restrict__ labels,
                 const float* __restrict__ thr, const float* __restrict__ gthr, int64_t n,
                 int k, bool aligned, int* __restrict__ part, unsigned* __restrict__ ticket,
                 int* __restrict__ out) {
  using S = Small<D>;
  using Tile = cdrs::WarpTile<T, D>;
  constexpr int THREADS = S::THREADS;
  constexpr int WARPS = S::WARPS;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* s_tiles = smem;                                      // WARPS * kStages
  float* s_thr = (float*)(smem + WARPS * kStages * Tile::BYTES);      // 2 * KMAX * D
  int* s_tot = (int*)(s_thr + 2 * S::KMAX * D);                       // CMAX

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = gridDim.x;
  const bool has_g = gthr != nullptr;
  const int kc = k * 2 * D;                  // per-cluster counters
  const int C = kc + (has_g ? 2 * D : 0);    // all counters
  const int nbits = k > 1 ? 32 - __clz(k - 1) : 0;   // bits of a cluster index
  for (int e = t; e < 2 * k * D; e += THREADS) s_thr[e] = thr[e];
  for (int c = t; c < C; c += THREADS) s_tot[c] = 0;
  float gt[2 * D];
#pragma unroll
  for (int e = 0; e < 2 * D; ++e) gt[e] = has_g ? gthr[e] : 0.f;
  // Lane j < k owns cluster j's 2D counters (for its warp's rows); every
  // thread counts its own rows' global compares.
  int cc[2 * D], gc[2 * D];
#pragma unroll
  for (int e = 0; e < 2 * D; ++e) cc[e] = gc[e] = 0;
  __syncthreads();

  const int64_t ntiles = (n + Tile::ROWS - 1) / Tile::ROWS;
  const int64_t gw = (int64_t)blockIdx.x * WARPS + warp;
  const int64_t nw = (int64_t)g * WARPS;
  const int my_tiles = gw < ntiles ? (int)((ntiles - gw + nw - 1) / nw) : 0;
  unsigned char* wt = s_tiles + warp * (kStages * Tile::BYTES);
  const int64_t total_bytes = n * D * (int64_t)sizeof(T);
  const unsigned char* xb = (const unsigned char*)x;
  auto issue = [&](int i) {
    if (i < my_tiles) {
      const int64_t off = (gw + (int64_t)i * nw) * Tile::BYTES;
      const int64_t left = total_bytes - off;
      cdrs::stage_warp_tile(wt + (i % kStages) * Tile::BYTES, xb + off,
                            left < Tile::BYTES ? (int)left : Tile::BYTES, aligned);
    }
    cdrs::cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  for (int i = 0; i < my_tiles; ++i) {
    const int64_t r = (gw + (int64_t)i * nw) * Tile::ROWS + lane;
    const int lab = r < n ? __ldg(labels + r) : -1;
    cdrs::cp_async_wait<kStages - 2>();
    __syncwarp();            // tile i is in; the warp is done with tile i - 1
    issue(i + kStages - 1);  // into tile i - 1's buffer
    const T* tx = (const T*)(wt + (i % kStages) * Tile::BYTES);
    const bool ok = lab >= 0 && lab < k;
    // Rows of cluster `lane`: the valid rows whose label bits match.
    unsigned mine = __ballot_sync(0xffffffffu, ok);
    for (int b = 0; b < nbits; ++b) {
      const unsigned bits = __ballot_sync(0xffffffffu, (lab >> b) & 1);
      mine &= ((lane >> b) & 1) ? bits : ~bits;
    }
    if (lane >= k) mine = 0u;
    // A row of no cluster compares as +inf: false against any threshold.
    float xr[D];
#pragma unroll
    for (int f = 0; f < D; ++f) xr[f] = ok ? to_f(tx[lane * D + f]) : INFINITY;
    const float* t0 = s_thr + (ok ? lab : 0) * D;
    const float* t1 = t0 + k * D;
#pragma unroll
    for (int f = 0; f < D; ++f) {
      cc[f] += __popc(__ballot_sync(0xffffffffu, xr[f] <= t0[f]) & mine);
      cc[D + f] += __popc(__ballot_sync(0xffffffffu, xr[f] <= t1[f]) & mine);
    }
    if (has_g) {
#pragma unroll
      for (int f = 0; f < D; ++f) {
        gc[f] += xr[f] <= gt[f];
        gc[D + f] += xr[f] <= gt[D + f];
      }
    }
  }
  cdrs::cp_async_wait<0>();

  // Block partial (integers: exact in any order), then the last block.
  if (lane < k) {
#pragma unroll
    for (int e = 0; e < 2 * D; ++e)
      if (cc[e]) atomicAdd(&s_tot[lane * 2 * D + e], cc[e]);
  }
  if (has_g) {
#pragma unroll
    for (int e = 0; e < 2 * D; ++e) {
      int v = gc[e];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
      if (lane == 0 && v) atomicAdd(&s_tot[kc + e], v);
    }
  }
  __syncthreads();
  for (int c = t; c < C; c += THREADS) part[(int64_t)c * g + blockIdx.x] = s_tot[c];
  if (!cdrs::last_block(ticket)) return;
  // Last block: the partials through the (now idle) tile buffers.
  constexpr int kCap = WARPS * kStages * Tile::BYTES / 4;
  cdrs::sum_block_partials(part, C, g, (int*)s_tiles, kCap, [&](int c, int v) { out[c] = v; });
  if (t == 0) *ticket = 0u;
}

template <typename T, int D>
cudaError_t launch_small(const Args& a) {
  using S = Small<D>;
  using Tile = cdrs::WarpTile<T, D>;
  static size_t smem_set[32] = {};
  static int per_sm = 0;
  const size_t smem = (size_t)S::WARPS * kStages * Tile::BYTES
                    + sizeof(float) * 2 * S::KMAX * D + sizeof(int) * S::CMAX;
  auto kern = seg_small_kernel<T, D>;
  cudaError_t err = cdrs::set_smem_once(kern, smem, smem_set);
  if (err == cudaSuccess) err = cdrs::blocks_per_sm_once(kern, S::THREADS, smem, per_sm);
  if (err != cudaSuccess) return err;
  const int64_t ntiles = (a.n + Tile::ROWS - 1) / Tile::ROWS;
  int64_t grid = (ntiles + S::WARPS - 1) / S::WARPS;
  if (grid > (int64_t)a.sms * per_sm) grid = (int64_t)a.sms * per_sm;
  if (grid > a.nb) grid = a.nb;
  if (grid < 1) grid = 1;
  const bool aligned = ((uintptr_t)a.x & 15) == 0;
  kern<<<(unsigned)grid, S::THREADS, smem, a.stream>>>(
      (const T*)a.x, a.labels, a.thr, a.gthr, a.n, a.k, aligned, a.part, a.ticket, a.out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t small_path(const Args& a) {
  switch (a.d) {
    case 1: return launch_small<T, 1>(a);
    case 2: return launch_small<T, 2>(a);
    case 3: return launch_small<T, 3>(a);
    case 4: return launch_small<T, 4>(a);
    case 5: return launch_small<T, 5>(a);
    case 6: return launch_small<T, 6>(a);
    case 7: return launch_small<T, 7>(a);
    default: return launch_small<T, 8>(a);
  }
}

// -------------------------------------------------------------- general path

template <typename T, bool SHARED>
__global__ void __launch_bounds__(kGenThreads)
seg_general_kernel(const T* __restrict__ x, const int* __restrict__ labels,
                   const float* __restrict__ thr, const float* __restrict__ gthr, int64_t n,
                   int d, int k, int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_g[];
  const int64_t kd = (int64_t)k * d;
  int* s_g = (int*)smem_g;                           // 2d global counters
  int* hist = out;                                   // (k, 2d) per-cluster counters
  const float* th = thr;
  for (int e = threadIdx.x; e < 2 * d; e += kGenThreads) s_g[e] = 0;
  if (SHARED) {
    hist = s_g + 2 * d;
    float* s_thr = (float*)(hist + 2 * kd);
    for (int64_t e = threadIdx.x; e < 2 * kd; e += kGenThreads) {
      hist[e] = 0;
      s_thr[e] = thr[e];
    }
    th = s_thr;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * kGenThreads + threadIdx.x) >> 5;
  const int64_t n_warps = ((int64_t)gridDim.x * kGenThreads) >> 5;
  for (int64_t i = warp; i < n; i += n_warps) {
    const int j = __ldg(labels + i);
    if (j < 0 || j >= k) continue;
    const T* xrow = x + i * d;
    for (int f = lane; f < d; f += 32) {
      const float v = to_f(xrow[f]);
      const int64_t ti = (int64_t)j * d + f;
      if (v <= th[ti]) atomicAdd(&hist[(int64_t)j * 2 * d + f], 1);
      if (v <= th[kd + ti]) atomicAdd(&hist[(int64_t)j * 2 * d + d + f], 1);
      if (gthr != nullptr) {
        if (v <= gthr[f]) atomicAdd(&s_g[f], 1);
        if (v <= gthr[d + f]) atomicAdd(&s_g[d + f], 1);
      }
    }
  }
  __syncthreads();
  if (SHARED) {
    for (int64_t e = threadIdx.x; e < 2 * kd; e += kGenThreads)
      if (hist[e]) atomicAdd(&out[e], hist[e]);
  }
  if (gthr != nullptr) {
    for (int e = threadIdx.x; e < 2 * d; e += kGenThreads)
      if (s_g[e]) atomicAdd(&out[2 * kd + e], s_g[e]);
  }
}

template <typename T>
cudaError_t general_path(const Args& a) {
  const size_t kd = (size_t)a.k * a.d;
  const size_t C = 2 * kd + (a.gthr != nullptr ? 2 * (size_t)a.d : 0);
  cudaError_t err = cudaMemsetAsync(a.out, 0, sizeof(int) * C, a.stream);
  if (err != cudaSuccess) return err;
  int64_t grid = (a.n + kGenThreads / 32 - 1) / (kGenThreads / 32);
  if (grid > a.nb) grid = a.nb;
  if (grid < 1) grid = 1;
  const size_t g_bytes = sizeof(int) * 2 * a.d;
  const size_t smem = g_bytes + sizeof(int) * 2 * kd + sizeof(float) * 2 * kd;
  if (smem <= kSmemBudget) {
    static size_t smem_set[32] = {};
    auto kern = seg_general_kernel<T, true>;
    err = cdrs::set_smem_once(kern, smem, smem_set);
    if (err != cudaSuccess) return err;
    kern<<<(unsigned)grid, kGenThreads, smem, a.stream>>>(
        (const T*)a.x, a.labels, a.thr, a.gthr, a.n, a.d, a.k, a.out);
  } else {
    seg_general_kernel<T, false><<<(unsigned)grid, kGenThreads, g_bytes, a.stream>>>(
        (const T*)a.x, a.labels, a.thr, a.gthr, a.n, a.d, a.k, a.out);
  }
  return cudaGetLastError();
}

bool uses_small_path(int d, int k) { return d <= 8 && k <= Small<8>::KMAX; }

template <typename T>
int launch(const Args& a) {
  if (a.n < 0 || a.d < 1 || a.k < 1 || a.nb < 2 || a.sms < 1) return (int)cudaErrorInvalidValue;
  if (2 * ((int64_t)a.k + 1) * a.d >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  if (uses_small_path(a.d, a.k)) return (int)small_path<T>(a);
  return (int)general_path<T>(a);
}

}  // namespace

extern "C" {

// Length of the `part` scratch a call at (d, k) needs with capacity nb: the
// small path's block partials, or nothing (one element) for the general
// path, which adds into the zeroed output.
int64_t cdrs_seg_count_part_len(int d, int k, int nb) {
  return uses_small_path(d, k) ? (int64_t)nb * (2 * (int64_t)k * d + 2 * d) : 1;
}

// x (n, d) row-major f32 or bf16; labels (n,) int32; thr (2, k, d) f32;
// gthr (2, d) f32 or NULL; out (k*2d + 2d, or k*2d without gthr) int32,
// written in full (zeroed first on the general path); part int32 scratch
// of cdrs_seg_count_part_len(d, k, nb); ticket one uint32, zero before the
// first launch (each launch leaves it zero); nb >= 2 the partial capacity
// in blocks (2 x SMs); sms the device's SM count.  Returns a cudaError_t
// code (0 = launched).
int cdrs_seg_count_f32(const void* x, const void* labels, const void* thr, const void* gthr,
                       int64_t n, int d, int k, void* out, void* part, void* ticket, int nb,
                       int sms, void* stream) {
  const Args a{x, (const int*)labels, (const float*)thr, (const float*)gthr, n, d, k,
               (int*)out, (int*)part, (unsigned*)ticket, nb, sms, (cudaStream_t)stream};
  return launch<float>(a);
}

int cdrs_seg_count_bf16(const void* x, const void* labels, const void* thr, const void* gthr,
                        int64_t n, int d, int k, void* out, void* part, void* ticket, int nb,
                        int sms, void* stream) {
  const Args a{x, (const int*)labels, (const float*)thr, (const float*)gthr, n, d, k,
               (int*)out, (int*)part, (unsigned*)ticket, nb, sms, (cudaStream_t)stream};
  return launch<__nv_bfloat16>(a);
}

}  // extern "C"
