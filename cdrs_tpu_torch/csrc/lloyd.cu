// Fused Lloyd step for Hopper (sm_90a): nearest-centroid labels plus the
// per-cluster (sum, count) statistics, in one pass over the points and one
// launch.
//
// Replaces both TPU kernels of the fused Lloyd step in
// cdrs_tpu/ops/pallas_kernels.py: lloyd_assign_reduce_pallas_t (feature-major,
// _kernel_t / _build_t; the full-batch Lloyd loop) and lloyd_assign_reduce_pallas
// (row-major with a runtime n_valid mask and every label, _kernel / _build; the
// mini-batch update and predict and the drift step).  The TPU needed two only
// for its lane padding of narrow rows; this kernel has the row-major contract.
// What it computes:
//   |c_j|^2 = sum_f c_jf * c_jf, added in feature order (mul, then add)
//   label_i = first argmin_j ( |c_j|^2 - 2 <x_i, c_j> )   (fmaf in feature order,
//             strict < over increasing j, no TF32)
//   sums[j] = sum_{i < n_valid, label_i = j} x_i     counts[j] = #{...}
//
// What bounds it on this card.  At the pipeline's shape (d = 5, k = 8) each
// row costs k*d FMAs per 4*d bytes read, ~2 FMA/byte: memory bound by a
// wide margin (the card does ~10 f32 FMA per byte of HBM).  At d = 32,
// k = 128 it is ~32 FMA/byte and at d = 128, k = 1024 ~256 FMA/byte, both on
// the f32 CUDA-core side of the roofline.
//
// Two paths, one launch each.  Both end the same way: each block writes its
// partial (sum, count) table, and the last block to take a ticket from an
// integer counter sums the partials in a fixed order, writes sums and the
// counts (as f32, from exact int32 totals), and resets the ticket.  No
// float atomics anywhere, so two calls on the same inputs give the same
// bits.
//
// * Small path (d <= 8, k <= 16: the pipeline, the stream path and drift).
//   D is a template constant and k is bucketed to K in {4, 8, 16}; padded
//   clusters get |c|^2 = +inf and never win.  Each warp walks its own
//   32-row tiles of x (warp w takes tiles w, w + all warps, ...), staged in
//   shared memory by 16-byte cp.async copies, three tiles in flight per
//   warp: coalesced although a 20-byte row is not 16-byte aligned, and with
//   no block-wide barrier in the loop.  A lane owns a row: its distances
//   and argmin are in registers, the centroids read as float4 broadcasts
//   from shared memory.  Its sums go to its thread's own slab in shared
//   memory, laid out cell-major (cell * THREADS + thread) so a warp's adds
//   hit 32 banks whatever the labels: D adds per row, where register
//   accumulators with compile-time indices cost K*D predicated adds per
//   row and measured slower.  Counts: lane j counts cluster j's rows of
//   its warp from one ballot of the counted rows and one per label bit.
//   At the end each cell is summed over the threads in a fixed order (lane
//   order, then a shuffle tree) and counts by integer adds.  1024 threads
//   at <= 64 registers keep 32 warps on each SM at K*D <= 40.
// * General path (any other shape: d = 32, k = 128 and d = 128, k = 1024).
//   A persistent grid of 2 x SMs blocks, block b owning a fixed contiguous
//   row range.  Centroids and |c|^2 sit in shared memory, in tiles of kt rows
//   when the whole table does not fit (d = 128, k = 1024 is 512 KB).  Per
//   chunk of 256 rows, G thread groups each own every G-th row and add into
//   their own shared-memory slab (one writer per (cluster, feature) cell);
//   slabs are summed in group order.  Counts are shared-memory integer
//   atomics (exact).  The last block sums the block partials cell by cell
//   (a thread per cell, or per four cells with 16-byte loads), blocks in
//   order.
// * with_labels = false (labels == NULL) skips the labels store.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "tile.cuh"

namespace {

using cdrs::kStages;
using cdrs::to_f;

constexpr int kThreads = 256;   // general path

struct Args {
  const void* x;
  const float* c;     // (k, d), already rounded to x's type
  int64_t n, n_valid;
  int d, k;
  int* labels;
  float* part_sums;   // block partials: (k*d, grid) small path, (grid, k*d) general
  int* part_counts;   // (k, grid) small path, (grid, k) general
  unsigned* ticket;   // zero between launches
  float* sums;        // (k, d)
  float* counts;      // (k,)
  int nb;             // partial capacity (blocks)
  int sms;            // streaming multiprocessors of the device
  cudaStream_t stream;
};

// |c_j|^2 in feature order, each product rounded before it is added (the
// plain version's order, so both versions rank alike bit for bit).
__device__ __forceinline__ float sq_norm(const float* cj, int d) {
  float s = 0.f;
  for (int f = 0; f < d; ++f) s = __fadd_rn(s, __fmul_rn(cj[f], cj[f]));
  return s;
}

// ---------------------------------------------------------------- small path

template <int D, int K>
struct Small {
  static constexpr int KD = K * D;
  static constexpr int KD4 = (KD + 3) & ~3;
  // One block per SM.  1024 threads capped at 64 registers (32 warps per
  // SM) up to K*D = 40, then 512 and 256 threads with more registers, so
  // the per-thread sum slabs (KD * THREADS floats) stay within 160 KB.
  static constexpr int THREADS = KD <= 40 ? 1024 : (KD <= 80 ? 512 : 256);
  static constexpr int WARPS = THREADS / 32;
  static constexpr int KBITS = K <= 4 ? 2 : (K <= 8 ? 3 : 4);   // bits of a cluster index
};

template <typename T, int D, int K>
__global__ void __launch_bounds__(Small<D, K>::THREADS, 1)
lloyd_small_kernel(const T* __restrict__ x, const float* __restrict__ c, int64_t n,
                   int64_t n_valid, int k, bool aligned, int* __restrict__ labels,
                   float* __restrict__ part_sums, int* __restrict__ part_counts,
                   unsigned* __restrict__ ticket, float* __restrict__ sums,
                   float* __restrict__ counts) {
  using S = Small<D, K>;
  using Tile = cdrs::WarpTile<T, D>;
  constexpr int KD = S::KD;
  constexpr int KD4 = S::KD4;
  constexpr int THREADS = S::THREADS;
  constexpr int WARPS = S::WARPS;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_acc = (float*)smem;                                        // KD * THREADS
  unsigned char* s_tiles = smem + sizeof(float) * KD * THREADS;       // WARPS * kStages
  float* s_c = (float*)(s_tiles + WARPS * kStages * Tile::BYTES);     // KD4
  float* s_csq = s_c + KD4;                                           // K

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = gridDim.x;
  for (int e = t; e < KD4; e += THREADS) s_c[e] = e < k * D ? c[e] : 0.f;
  // Thread t's sums live at s_acc[cell * THREADS + t]: lanes of a warp hit
  // 32 different banks whatever their clusters.
#pragma unroll
  for (int e = 0; e < KD; ++e) s_acc[e * THREADS + t] = 0.f;
  int cnt = 0;   // lane j < K: rows of cluster j among its warp's rows
  __syncthreads();
  for (int j = t; j < K; j += THREADS) s_csq[j] = j < k ? sq_norm(s_c + j * D, D) : INFINITY;
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
    cdrs::cp_async_wait<kStages - 2>();
    __syncwarp();            // tile i is in; the warp is done with tile i - 1
    issue(i + kStages - 1);  // into tile i - 1's buffer
    const T* tx = (const T*)(wt + (i % kStages) * Tile::BYTES);
    const int64_t r = (gw + (int64_t)i * nw) * Tile::ROWS + lane;
    float xr[D];
#pragma unroll
    for (int f = 0; f < D; ++f) xr[f] = to_f(tx[lane * D + f]);
    // Distances in flat (cluster, feature) order: each dot adds its
    // features in order 0..D-1; the first minimum over increasing j wins.
    float best = INFINITY, dot = 0.f;
    int best_j = 0;
#pragma unroll
    for (int q4 = 0; q4 < KD4 / 4; ++q4) {
      const float4 v = reinterpret_cast<const float4*>(s_c)[q4];
      const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = 4 * q4 + u;
        if (e < KD) {
          dot = fmaf(xr[e % D], w[u], dot);
          if (e % D == D - 1) {
            const float dist = s_csq[e / D] - 2.f * dot;
            if (dist < best) { best = dist; best_j = e / D; }
            dot = 0.f;
          }
        }
      }
    }
    if (labels != nullptr && r < n) labels[r] = best_j;
    const bool counted = r < n_valid;
    if (counted) {
      float* a = s_acc + best_j * D * THREADS + t;
#pragma unroll
      for (int f = 0; f < D; ++f) a[f * THREADS] += xr[f];
    }
    // Counts: lane j takes the rows of cluster j from one ballot of the
    // counted rows and one per label bit.
    unsigned mine = __ballot_sync(0xffffffffu, counted);
#pragma unroll
    for (int b = 0; b < S::KBITS; ++b) {
      const unsigned bits = __ballot_sync(0xffffffffu, (best_j >> b) & 1);
      mine &= ((lane >> b) & 1) ? bits : ~bits;
    }
    cnt += __popc(mine);
  }
  cdrs::cp_async_wait<0>();
  __syncthreads();

  // Block partial.  Sums: cell e over threads 0..THREADS-1, lane l adding
  // l, l + 32, ... then a fixed shuffle tree.  Counts: integers, exact in
  // any order.
  int* s_cnt = (int*)s_tiles;   // WARPS * K
  if (lane < K) s_cnt[warp * K + lane] = cnt;
  const int kd = k * D;
  for (int e = warp; e < kd; e += WARPS) {
    float v = 0.f;
#pragma unroll 8
    for (int tt = lane; tt < THREADS; tt += 32) v += s_acc[e * THREADS + tt];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) part_sums[(int64_t)e * g + blockIdx.x] = v;
  }
  __syncthreads();
  for (int j = t; j < k; j += THREADS) {
    int v = 0;
    for (int w = 0; w < WARPS; ++w) v += s_cnt[w * K + j];
    part_counts[(int64_t)j * g + blockIdx.x] = v;
  }
  if (!cdrs::last_block(ticket)) return;
  // Last block: the partials through the (now idle) tile buffers.
  constexpr int kCap = WARPS * kStages * Tile::BYTES / 4;
  cdrs::sum_block_partials(part_sums, kd, g, (float*)s_tiles, kCap,
                           [&](int e, float v) { sums[e] = v; });
  cdrs::sum_block_partials(part_counts, k, g, (int*)s_tiles, kCap,
                           [&](int j, int v) { counts[j] = (float)v; });
  if (t == 0) *ticket = 0u;
}

template <typename T, int D, int K>
cudaError_t launch_small(const Args& a) {
  using S = Small<D, K>;
  using Tile = cdrs::WarpTile<T, D>;
  static size_t smem_set[32] = {};
  static int per_sm = 0;
  const size_t smem = sizeof(float) * S::KD * S::THREADS
                    + (size_t)S::WARPS * kStages * Tile::BYTES + sizeof(float) * (S::KD4 + K);
  auto kern = lloyd_small_kernel<T, D, K>;
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
      (const T*)a.x, a.c, a.n, a.n_valid, a.k, aligned, a.labels, a.part_sums, a.part_counts,
      a.ticket, a.sums, a.counts);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t small_k(const Args& a) {
  if (a.k <= 4) return launch_small<T, D, 4>(a);
  if (a.k <= 8) return launch_small<T, D, 8>(a);
  return launch_small<T, D, 16>(a);
}

template <typename T>
cudaError_t small_path(const Args& a) {
  switch (a.d) {
    case 1: return small_k<T, 1>(a);
    case 2: return small_k<T, 2>(a);
    case 3: return small_k<T, 3>(a);
    case 4: return small_k<T, 4>(a);
    case 5: return small_k<T, 5>(a);
    case 6: return small_k<T, 6>(a);
    case 7: return small_k<T, 7>(a);
    default: return small_k<T, 8>(a);
  }
}

// -------------------------------------------------------------- general path

constexpr size_t kTileBytes = 64 * 1024;   // centroid tile budget
constexpr size_t kSlabBytes = 64 * 1024;   // statistics slab budget
constexpr int kJB = 16;                    // centroids per register tile (d > 32)
constexpr int kFC = 32;                    // features per register chunk (d > 32)

struct Plan {
  int kt;       // centroid rows per distance tile
  int gs;       // threads per group (features handled by a group)
  int groups;   // groups G
  int kts;      // clusters per statistics slab
  size_t smem;  // dynamic shared memory bytes
};

Plan make_plan(int d, int k) {
  Plan p;
  int kt = (int)(kTileBytes / (sizeof(float) * (size_t)(d + 1)));
  p.kt = kt < k ? (kt < 1 ? 1 : kt) : k;
  p.gs = d < kThreads ? d : kThreads;
  int groups = kThreads / p.gs;
  size_t cell = sizeof(float) * (size_t)k * d;
  int fit = (int)(kSlabBytes / cell);
  if (fit >= 1) {
    p.groups = fit < groups ? fit : groups;
    p.kts = k;
  } else {
    p.groups = 1;
    int kts = (int)(kSlabBytes / (sizeof(float) * (size_t)d));
    p.kts = kts < 1 ? 1 : kts;
  }
  p.smem = sizeof(float) * (size_t)p.kt * (d + 1)            // centroid tile + |c|^2
         + sizeof(int) * kThreads                            // chunk labels
         + sizeof(int) * (size_t)k                           // block counts
         + sizeof(float) * (size_t)p.groups * p.kts * d;     // slabs
  return p;
}

// DMAX > 0: rows (d <= DMAX) are loaded once into registers; DMAX == 0: any d,
// the row is re-read (from L1) once per tile of kJB centroids.
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
lloyd_stats_kernel(const T* __restrict__ x, const float* __restrict__ c,
                   int64_t n, int64_t n_valid,
                   int d, int k, int64_t rows_per_block, Plan plan,
                   int* __restrict__ labels, float* __restrict__ part_sums,
                   int* __restrict__ part_counts, unsigned* __restrict__ ticket,
                   float* __restrict__ sums, float* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_c = (float*)smem;                           // kt * d
  float* s_csq = s_c + (size_t)plan.kt * d;            // kt
  int* s_lab = (int*)(s_csq + plan.kt);                // kThreads
  int* s_cnt = s_lab + kThreads;                       // k
  float* s_slab = (float*)(s_cnt + k);                 // groups * kts * d

  const int t = threadIdx.x;
  const int64_t b = blockIdx.x;
  const int64_t row0 = b * rows_per_block;
  int64_t row1 = row0 + rows_per_block;
  if (row1 > n) row1 = n;
  const int64_t kd = (int64_t)k * d;
  float* my_part = part_sums + b * kd;   // block-major partials
  const int slab_elems = plan.groups * plan.kts * d;
  const bool one_tile = plan.kt >= k;
  const bool one_slab = plan.kts >= k;

  for (int j = t; j < k; j += kThreads) s_cnt[j] = 0;
  if (one_slab) {
    for (int e = t; e < slab_elems; e += kThreads) s_slab[e] = 0.f;
  } else {
    for (int64_t e = t; e < kd; e += kThreads) my_part[e] = 0.f;
  }
  if (one_tile) {
    for (int e = t; e < k * d; e += kThreads) s_c[e] = c[e];
    __syncthreads();
    for (int j = t; j < k; j += kThreads) s_csq[j] = sq_norm(s_c + (size_t)j * d, d);
  }
  __syncthreads();

  const int grp = t / plan.gs;
  const int lane = t - grp * plan.gs;

  for (int64_t base = row0; base < row1; base += kThreads) {
    const int64_t r = base + t;
    const bool in = r < row1;
    const T* xrow = x + r * d;
    float xr[DMAX > 0 ? DMAX : 1];
    if (DMAX > 0 && in) {
#pragma unroll
      for (int f = 0; f < DMAX; ++f)
        if (f < d) xr[f] = to_f(xrow[f]);
    }
    float best = INFINITY;
    int best_j = 0;
    for (int j0 = 0; j0 < k; j0 += plan.kt) {
      const int ktc = (k - j0) < plan.kt ? (k - j0) : plan.kt;
      if (!one_tile) {
        __syncthreads();
        for (int e = t; e < ktc * d; e += kThreads) s_c[e] = c[(int64_t)j0 * d + e];
        __syncthreads();
        for (int j = t; j < ktc; j += kThreads) s_csq[j] = sq_norm(s_c + (size_t)j * d, d);
        __syncthreads();
      }
      if (in && DMAX > 0) {
        for (int j = 0; j < ktc; ++j) {
          const float* cj = s_c + (size_t)j * d;
          float dot = 0.f;
#pragma unroll
          for (int f = 0; f < (DMAX > 0 ? DMAX : 1); ++f)
            if (f < d) dot = fmaf(xr[f], cj[f], dot);
          const float dist = s_csq[j] - 2.f * dot;
          if (dist < best) { best = dist; best_j = j0 + j; }
        }
      } else if (in) {
        // Any d: kJB centroids at a time, the row streamed through registers
        // kFC features at a time, so each row element is loaded once per kJB
        // centroids.  Each dot still adds its features in order 0..d-1.
        for (int jb = 0; jb < ktc; jb += kJB) {
          const int nj = (ktc - jb) < kJB ? (ktc - jb) : kJB;
          float acc[kJB];
#pragma unroll
          for (int q = 0; q < kJB; ++q) acc[q] = 0.f;
          for (int f0 = 0; f0 < d; f0 += kFC) {
            float xc[kFC];
#pragma unroll
            for (int f = 0; f < kFC; ++f) xc[f] = (f0 + f < d) ? to_f(xrow[f0 + f]) : 0.f;
#pragma unroll
            for (int q = 0; q < kJB; ++q) {
              if (q < nj) {
                const float* cq = s_c + (size_t)(jb + q) * d + f0;
#pragma unroll
                for (int f = 0; f < kFC; ++f)
                  if (f0 + f < d) acc[q] = fmaf(xc[f], cq[f], acc[q]);
              }
            }
          }
#pragma unroll
          for (int q = 0; q < kJB; ++q) {
            if (q < nj) {
              const float dist = s_csq[jb + q] - 2.f * acc[q];
              if (dist < best) { best = dist; best_j = j0 + jb + q; }
            }
          }
        }
      }
    }
    if (in && labels != nullptr) labels[r] = best_j;
    const int lab = (in && r < n_valid) ? best_j : -1;
    s_lab[t] = lab;
    if (lab >= 0) atomicAdd(&s_cnt[lab], 1);
    __syncthreads();

    if (one_slab) {
      if (grp < plan.groups) {
        float* slab = s_slab + (size_t)grp * plan.kts * d;
        for (int rr = grp; rr < kThreads; rr += plan.groups) {
          const int lj = s_lab[rr];
          if (lj < 0) continue;
          const T* xs = x + (base + rr) * d;
          for (int f = lane; f < d; f += plan.gs) slab[lj * d + f] += to_f(xs[f]);
        }
      }
      __syncthreads();  // s_lab is rewritten by the next chunk
      continue;
    }
    for (int k0 = 0; k0 < k; k0 += plan.kts) {
      const int ktc = (k - k0) < plan.kts ? (k - k0) : plan.kts;
      const int cells = ktc * d;
      for (int e = t; e < slab_elems; e += kThreads) s_slab[e] = 0.f;
      __syncthreads();
      if (grp < plan.groups) {
        float* slab = s_slab + (size_t)grp * plan.kts * d;
        for (int rr = grp; rr < kThreads; rr += plan.groups) {
          const int lj = s_lab[rr] - k0;
          if (s_lab[rr] < 0 || lj < 0 || lj >= ktc) continue;
          const T* xs = x + (base + rr) * d;
          for (int f = lane; f < d; f += plan.gs) slab[lj * d + f] += to_f(xs[f]);
        }
      }
      __syncthreads();
      for (int e = t; e < cells; e += kThreads) {
        float s = 0.f;
        for (int gg = 0; gg < plan.groups; ++gg) s += s_slab[(size_t)gg * plan.kts * d + e];
        my_part[(int64_t)k0 * d + e] += s;
      }
      __syncthreads();
    }
  }
  __syncthreads();
  if (one_slab) {
    for (int64_t e = t; e < kd; e += kThreads) {
      float s = 0.f;
      for (int gg = 0; gg < plan.groups; ++gg) s += s_slab[(size_t)gg * plan.kts * d + e];
      my_part[e] = s;
    }
  }
  for (int j = t; j < k; j += kThreads) part_counts[b * k + j] = s_cnt[j];
  if (!cdrs::last_block(ticket)) return;
  // Last block: one thread per cell (four when they fill 16-byte loads),
  // blocks in order, coalesced across the block's threads and unrolled so
  // that many loads are in flight: at d = 128, k = 1024 this one block
  // reads 264 x 131,072 partials.
  const int g = gridDim.x;
  if (kd % 4 == 0) {   // four cells per thread, one 16-byte load per block
    const float4* p4 = reinterpret_cast<const float4*>(part_sums);
    for (int64_t q = t; q < kd / 4; q += kThreads) {
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 16
      for (int bb = 0; bb < g; ++bb) {
        const float4 v = __ldcg(p4 + bb * (kd / 4) + q);
        s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
      }
      reinterpret_cast<float4*>(sums)[q] = s;
    }
  } else {
    for (int64_t e = t; e < kd; e += kThreads) {
      float s = 0.f;
#pragma unroll 16
      for (int bb = 0; bb < g; ++bb) s += __ldcg(part_sums + bb * kd + e);
      sums[e] = s;
    }
  }
  for (int j = t; j < k; j += kThreads) {
    int s = 0;
    for (int bb = 0; bb < g; ++bb) s += __ldcg(part_counts + (int64_t)bb * k + j);
    counts[j] = (float)s;
  }
  if (t == 0) *ticket = 0u;
}

template <typename T, int DMAX>
cudaError_t launch_general(const Args& a, const Plan& plan) {
  static size_t smem_set[32] = {};
  auto kern = lloyd_stats_kernel<T, DMAX>;
  cudaError_t err = cdrs::set_smem_once(kern, plan.smem, smem_set);
  if (err != cudaSuccess) return err;
  int64_t grid = (a.n + kThreads - 1) / kThreads;
  if (grid > a.nb) grid = a.nb;
  if (grid < 1) grid = 1;
  const int64_t rows_per_block = (a.n + grid - 1) / grid;
  kern<<<(unsigned)grid, kThreads, plan.smem, a.stream>>>(
      (const T*)a.x, a.c, a.n, a.n_valid, a.d, a.k, rows_per_block, plan, a.labels,
      a.part_sums, a.part_counts, a.ticket, a.sums, a.counts);
  return cudaGetLastError();
}

template <typename T>
cudaError_t general_path(const Args& a) {
  const Plan plan = make_plan(a.d, a.k);
  if (plan.smem > 227 * 1024) return cudaErrorInvalidValue;
  if (a.d <= 8) return launch_general<T, 8>(a, plan);
  if (a.d <= 32) return launch_general<T, 32>(a, plan);
  return launch_general<T, 0>(a, plan);
}

template <typename T>
int launch(const Args& a) {
  if (a.n < 0 || a.d < 1 || a.k < 1 || a.nb < 2 || a.sms < 1 || a.n_valid < 0 || a.n_valid > a.n)
    return (int)cudaErrorInvalidValue;
  if (a.d <= 8 && a.k <= 16) return (int)small_path<T>(a);
  return (int)general_path<T>(a);
}

}  // namespace

extern "C" {

// x (n, d) row-major f32 or bf16; c (k, d) f32 (already rounded to x's type;
// |c|^2 is taken in the kernel); labels (n,) int32 or NULL; part_sums
// (nb * k * d) f32 and
// part_counts (nb * k) int32 scratch; ticket one uint32, zero before the
// first launch (each launch leaves it zero); sums (k, d) f32; counts (k,) f32.
// nb >= 2 is the partial capacity in blocks (2 x SMs); sms the device's
// SM count.  Returns a cudaError_t code (0 = launched).
int cdrs_lloyd_f32(const void* x, const void* c, int64_t n, int64_t n_valid,
                   int d, int k, void* labels, void* part_sums, void* part_counts,
                   void* ticket, void* sums, void* counts, int nb, int sms, void* stream) {
  const Args a{x, (const float*)c, n, n_valid, d, k, (int*)labels,
               (float*)part_sums, (int*)part_counts, (unsigned*)ticket, (float*)sums,
               (float*)counts, nb, sms, (cudaStream_t)stream};
  return launch<float>(a);
}

int cdrs_lloyd_bf16(const void* x, const void* c, int64_t n, int64_t n_valid,
                    int d, int k, void* labels, void* part_sums, void* part_counts,
                    void* ticket, void* sums, void* counts, int nb, int sms, void* stream) {
  const Args a{x, (const float*)c, n, n_valid, d, k, (int*)labels,
               (float*)part_sums, (int*)part_counts, (unsigned*)ticket, (float*)sums,
               (float*)counts, nb, sms, (cudaStream_t)stream};
  return launch<__nv_bfloat16>(a);
}

}  // extern "C"
