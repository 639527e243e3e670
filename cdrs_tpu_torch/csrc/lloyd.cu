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
//   label_i = first argmin_j ( |c_j|^2 - 2 <x_i, c_j> )   (first minimum wins)
//   sums[j] = sum_{i < n_valid, label_i = j} x_i     counts[j] = #{...}
// No float atomics anywhere: sums are added in a fixed order and counts are
// integers, so two calls on the same inputs give the same bits.
//
// Three paths, one launch each.
//
// * Small path (d <= 8, k <= 16: the pipeline, the stream path and drift).
//   At d = 5, k = 8 a row costs k*d FMAs per 4*d bytes read, ~2 FMA/byte:
//   memory bound by a wide margin.  D is a template constant and k is
//   bucketed to K in {4, 8, 16}; padded clusters get |c|^2 = +inf and never
//   win.  Dot products are fmaf chains in feature order (no TF32).  Each
//   warp walks its own 32-row tiles of x (warp w takes tiles w, w + all
//   warps, ...), staged in shared memory by 16-byte cp.async copies, three
//   tiles in flight per warp: coalesced although a 20-byte row is not
//   16-byte aligned, and with no block-wide barrier in the loop.  A lane
//   owns a row: its distances and argmin are in registers, the centroids
//   read as float4 broadcasts from shared memory.  Its sums go to its
//   thread's own slab in shared memory, laid out cell-major (cell * THREADS
//   + thread) so a warp's adds hit 32 banks whatever the labels.  Counts:
//   lane j counts cluster j's rows of its warp from one ballot of the
//   counted rows and one per label bit.  At the end each cell is summed over
//   the threads in a fixed order (lane order, then a shuffle tree), and the
//   last block to take a ticket from an integer counter sums the block
//   partials in block order and resets the ticket.
//
// * General paths (every other shape).  What bounds them: 2 n k d
//   operations against 4 n d bytes (f32) is k/2 operations a byte, 64 at
//   k = 128 and 512 at k = 1024, so f32 work is bound by operations (at
//   495 / 3 TFLOP/s, the f32-accurate rate of the tensor cores); bf16
//   points halve the bytes and their products run at 989 TFLOP/s, so
//   1M x 32, k = 128 in bf16 is bound by its bytes.  ops/lloyd.py's plan()
//   picks the path from (d, k, dtype) and passes it with each call:
//   - the wgmma path (csrc/lloyd_wgmma.cuh, whose note gives its design)
//     where a row is a whole number of 16-byte units (TMA's row stride:
//     d % 4 == 0 for f32, d % 8 == 0 for bf16) and a 256-row tile fits a
//     block: configs 2 and 3 and the rehearsal;
//   - the mma_sync path (namespace gen below) for the rest: entry()'s
//     d = 5, k = 64, odd bf16 rows (d = 37), rows too wide for a 256-row
//     tile (d = 300).
//   mma_sync path.  A block of 256 threads (8 warps, 4 along the rows x 2
//   along the centroids) takes 128-row tiles of x; a warp computes a
//   32-row x (8 WN)-centroid block of dot products with mma.sync (m16n8k8
//   TF32 for f32 points, m16n8k16 bf16), f32 accumulators in registers.
//   Every block first writes its share of csplit (c in the layout the
//   products read, f32 split once into TF32 high and low parts), then a
//   grid barrier.  Either all of csplit sits in shared memory and x
//   streams through a ring of up to 8 tiles (two blocks an SM), or a
//   two-slot ring carries (x chunk, c chunk) pairs, so any d is served.  x
//   is staged by cp.async copies (16 bytes where rows allow, down to plain
//   2-byte copies) at a padded row stride that makes every fragment load
//   hit 32 banks.  The depth is padded to the instruction's: c's padding
//   is zero, x's last step is masked.  The epilogue of each centroid tile
//   keeps a running best per row; the lanes and warps of a row merge by
//   (distance, index).  Sums: counts are shared-memory integer atomics;
//   cluster j belongs to warp j mod 8 and lane l adds features l, l + 32,
//   ... of its rows in row order (one writer a cell).  When the (k, d)
//   table fits in 64 KB the rows are added from the staged tile; else the
//   labels are stored and the block makes passes over its own rows, each
//   owning as many clusters as its freed shared memory holds.  A second
//   grid barrier, then every block sums its cells over the block
//   partials in block order.
// * The split product (f32 points, both general paths).  Each operand v is
//   split as hi = rna_tf32(v), lo = rna_tf32(v - hi) (cvt.rna: round to
//   nearest, ties away, 10 stored mantissa bits): c once a launch, x as it
//   is loaded into a fragment.  x.c is taken a k-step of 8 features at a
//   time as lo.hi' + hi.lo' + hi.hi' (three tensor-core products; lo.lo'
//   dropped).  |v - hi - lo| <= 2^-22 |v|, so each term's error is at most
//   3.01 * 2^-22 |x_f c_f| < 2^-20 |x_f c_f|, and with the f32 additions of
//   3 d products (round or truncate, 2^-23 each):
//     |dot - x.c| <= (2^-20 + 3 d 2^-23) * sum_f |x_f c_f|,
//   the order of an f32 dot product's own rounding (the plain version's
//   cuBLAS product: d 2^-24).  Each distance |c|^2 - 2 dot carries twice
//   that, so a label can differ from the plain version's only where two
//   distances lie within the sum of their errors.  bf16 points: the
//   products of bf16 values are exact in f32, so one bf16 product, c
//   rounded to bf16 by the wrapper.
// * with_labels = false (labels == NULL) skips the labels store; the
//   general paths need a label buffer where they do not keep the sums in
//   shared memory (cdrs_lloyd_plan_info's out[1]).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "lloyd_wgmma.cuh"
#include "tile.cuh"

namespace {

using cdrs::kStages;
using cdrs::to_f;
using lloyd_shared::sq_norm;

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
  int* order;         // (n,) scratch of the wgmma path's sorted sums (NULL: none)
};

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

namespace gen {

constexpr int kThreads = 256;                 // 8 warps: 4 along the rows x 2 along c
constexpr int kWarps = kThreads / 32;
constexpr int kBM = 128;                      // rows per tile, 32 per row warp
constexpr int kLabChunk = kThreads;           // labels per chunk of a statistics pass
constexpr size_t kSmemMax = 227 * 1024;
constexpr size_t kInlineBytes = 64 * 1024;    // (k, d) sums kept whole in shared memory
constexpr size_t kXRingBytes = 64 * 1024;     // x ring when c is resident
constexpr int kMaxStages = 8;

struct Params {
  const void* x;
  const float* c;
  int64_t n, n_valid;
  int d, k;
  int* labels;          // labels (or the wrapper's scratch); NULL: none kept
  float* part_sums;     // (grid, k*d) block partials
  float* csplit;        // c as the products read it, written once a launch (csplit_c)
  int* part_counts;     // (grid, k)
  float* sums;          // (k, d)
  float* counts;        // (k,)
  int64_t tiles_per_block;
  int resident;         // 1: all of c in shared memory, x through a ring of `stages`
  int stages;
  int dc, nfc;          // features a chunk, chunks (resident: d, 1)
  int xs, cs;           // shared row strides: x (elements), c (floats)
  int kp;               // k rounded up to the centroid tile
  int xgran;            // x's copy granularity in bytes (16, 8, 4 or 2)
  int cchunk;           // bytes of one (centroid tile, feature chunk) of csplit
  int inline_stats;     // 1: the (k, d) sums in shared memory through the pass
  int slab;             // clusters a statistics pass (inline_stats = 0)
  int gather;           // rows a pass stages at once (inline_stats = 0)
  int off_stage, off_list;   // a pass's staged rows, and its row and label lists
  int off_c, off_csq, off_cnt, off_lab, off_best, off_acc;   // shared-memory offsets
  int slot_bytes, slot_c;   // chunk ring: one slot, and its c part's offset
};

// ---- fragments and products

using lloyd_shared::split_tf32;

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <typename T> __host__ __device__ constexpr int depth() { return sizeof(T) == 4 ? 8 : 16; }
__host__ __device__ inline int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// One instruction-depth step of a warp's 32 x 8 WN block of dot products.
// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32 / m16n8k16 .bf16; g = lane / 4,
// t = lane % 4): A rows g and g + 8 of each 16-row tile, B column g of each
// 8-centroid tile.  xa points at x_tile[row g of the warp][t (f32) or 2t
// (bf16)], cb at c_tile[centroid g of the warp][the same], k0 is the step's
// first feature and w the features staged: with MASK, operands at w or past
// are taken as zero (the depth's padding).
template <int WN, bool MASK>
__device__ __forceinline__ void mma_step(float (&acc)[2][WN][4], const float* xa, int xs,
                                         const float* cb, int cs, int k0, int w, int t) {
  uint32_t ah[2][4], al[2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const float* r0 = xa + mt * 16 * xs + k0;
    const float* r1 = r0 + 8 * xs;
    float v[4] = {r0[0], r1[0], r0[4], r1[4]};
    if (MASK) {
      if (k0 + t >= w) v[0] = v[1] = 0.f;
      if (k0 + t + 4 >= w) v[2] = v[3] = 0.f;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) split_tf32(v[q], ah[mt][q], al[mt][q]);
  }
  const float* cl = cb + 16 * WN * cs;   // c's low parts follow its high parts
#pragma unroll
  for (int nt = 0; nt < WN; ++nt) {    // c was split once (csplit_c), zero-padded
    const int o = nt * 8 * cs + k0;
    const uint32_t bh0 = __float_as_uint(cb[o]), bh1 = __float_as_uint(cb[o + 4]);
    const uint32_t bl0 = __float_as_uint(cl[o]), bl1 = __float_as_uint(cl[o + 4]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {   // small terms first, then hi.hi'
      mma_tf32(acc[mt][nt], al[mt], bh0, bh1);
      mma_tf32(acc[mt][nt], ah[mt], bl0, bl1);
      mma_tf32(acc[mt][nt], ah[mt], bh0, bh1);
    }
  }
}

template <bool MASK>
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p, int col, int w) {
  if (!MASK || col + 1 < w) return *reinterpret_cast<const uint32_t*>(p);
  if (col < w) return (uint32_t)*reinterpret_cast<const uint16_t*>(p);
  return 0u;
}

template <int WN, bool MASK>
__device__ __forceinline__ void mma_step(float (&acc)[2][WN][4], const __nv_bfloat16* xa,
                                         int xs, const float* cb, int cs, int k0, int w,
                                         int t) {
  const int col = k0 + 2 * t;
  uint32_t a[2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const __nv_bfloat16* r0 = xa + mt * 16 * xs + k0;
    const __nv_bfloat16* r1 = r0 + 8 * xs;
    a[mt][0] = ld_pair<MASK>(r0, col, w);
    a[mt][1] = ld_pair<MASK>(r1, col, w);
    a[mt][2] = ld_pair<MASK>(r0 + 8, col + 8, w);
    a[mt][3] = ld_pair<MASK>(r1 + 8, col + 8, w);
  }
#pragma unroll
  for (int nt = 0; nt < WN; ++nt) {
    const float* cr = cb + nt * 8 * cs + k0;
    const float2 u0 = *reinterpret_cast<const float2*>(cr);   // zero-padded (csplit_c)
    const float2 u1 = *reinterpret_cast<const float2*>(cr + 8);
    const uint32_t b0 = pack_bf16(u0.x, u0.y), b1 = pack_bf16(u1.x, u1.y);   // exact
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt][nt], a[mt], b0, b1);
  }
}

// c as the products read it: for each (centroid tile, feature chunk) a block
// of cchunk bytes holding the tile's BN centroids x cs features, row-major,
// features past the chunk and centroids past k zero: for f32 points the
// TF32 high parts, then the low parts (split once here, not per tile); for
// bf16 points the values (already rounded to bf16).  Every block writes its
// share; a grid barrier follows.
template <typename T>
__device__ void csplit_c(const Params& p, int bn) {
  const int64_t part = (int64_t)bn * p.cs;   // floats of one part of a chunk
  const int64_t total = (int64_t)p.kp * p.nfc * p.cs;
  for (int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * kThreads) {
    const int64_t chunk = e / part;   // jt * nfc + fc
    const int off = (int)(e - chunk * part);
    const int jt = (int)(chunk / p.nfc), fc = (int)(chunk - (int64_t)jt * p.nfc);
    const int n = off / p.cs, ff = off - n * p.cs;
    const int j = jt * bn + n, f = fc * p.dc + ff;
    const float v = (j < p.k && ff < p.dc && f < p.d) ? p.c[(int64_t)j * p.d + f] : 0.f;
    float* dst = (float*)((unsigned char*)p.csplit + chunk * p.cchunk) + off;
    if (sizeof(T) == 4) {
      uint32_t hi, lo;
      split_tf32(v, hi, lo);
      dst[0] = __uint_as_float(hi);
      dst[part] = __uint_as_float(lo);
    } else {
      dst[0] = v;
    }
  }
}

// ---- staging and statistics

// Starts the copy of `gran` bytes (16, 8 or 4: cp.async; 2: a plain load
// and store, complete at once).
__device__ __forceinline__ void copy_chunk(unsigned char* dst, const unsigned char* src, int gran) {
  if (gran == 16) cdrs::cp_async16(dst, src, 16);
  else if (gran == 8) cdrs::cp_async8(dst, src);
  else if (gran == 4) cdrs::cp_async4(dst, src);
  else *reinterpret_cast<uint16_t*>(dst) = *reinterpret_cast<const uint16_t*>(src);
}

// Adds rows 0..rows-1 whose clusters lab[] (shared; -1: not counted) fall in
// [s0, s0 + ns) into acc[(j - s0) * d + f].  Of the NW warps of the group,
// cluster j belongs to warp j % NW (`warp` is the caller's) and feature f
// to its lane f % 32: one writer a cell, rows in increasing order, so the
// same inputs give the same bits.  Up to four rows are fetched before they
// are added, so a gather from device memory keeps several loads in flight.
template <int NW, typename Get>
__device__ __forceinline__ void add_rows(float* acc, const int* lab, int rows, int s0, int ns,
                                         int d, int warp, Get get) {
  const int lane = threadIdx.x & 31;
  for (int r0 = 0; r0 < rows; r0 += 32) {
    const int j = r0 + lane < rows ? lab[r0 + lane] : -1;
    const int rel = j - s0;
    unsigned m = __ballot_sync(0xffffffffu, j >= 0 && rel >= 0 && rel < ns && (j % NW) == warp);
    while (m) {
      int rr[4], jr[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int b = m ? __ffs(m) - 1 : -1;
        rr[q] = b;
        jr[q] = __shfl_sync(0xffffffffu, rel, b < 0 ? 0 : b);
        if (m) m &= m - 1;
      }
      for (int f = lane; f < d; f += 32) {
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = rr[q] >= 0 ? get(r0 + rr[q], f) : 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (rr[q] >= 0) acc[jr[q] * d + f] += v[q];
      }
    }
  }
}

// The sums of a block's counted rows [r0, r1) when the (k, d) table does
// not fit in shared memory: passes over the rows' stored labels, each pass
// owning `slab` clusters in `smem` (from offset 0; the rows staged at
// off_stage, the pass's row and label lists at off_list).  For each chunk of
// NT labels the rows of the pass's clusters are listed in row order, copied
// in by cp.async, `gather` at a time (`gran` bytes a copy), and added from
// shared memory.  NT threads (`tid` in [0, NT)) take part; `sync` is their
// barrier and s_wcnt holds NT / 32 ints.  Each cell of the block's partial
// my_part is written once.
template <typename T, int NT, typename Sync>
__device__ void stat_passes(unsigned char* smem, int off_stage, int off_list, int* s_wcnt,
                            const int* labels, const unsigned char* xb, int64_t r0, int64_t r1,
                            int k, int d, int slab, int gather, int gran, float* my_part,
                            int tid, Sync sync) {
  constexpr int NW = NT / 32;
  const int lane = tid & 31, warp = tid >> 5;
  float* s_slab = (float*)smem;
  T* stage = (T*)(smem + off_stage);
  int* s_list = (int*)(smem + off_list);
  int* s_plab = s_list + NT;
  const int row_bytes = d * (int)sizeof(T), per = row_bytes / gran;
  for (int s0 = 0; s0 < k; s0 += slab) {
    const int ns = min(slab, k - s0);
    for (int e = tid; e < ns * d; e += NT) s_slab[e] = 0.f;
    for (int64_t base = r0; base < r1; base += NT) {
      const int64_t r = base + tid;
      const int lab = r < r1 ? __ldcg(labels + r) : -1;
      const bool in = lab >= s0 && lab < s0 + ns;
      const unsigned bal = __ballot_sync(0xffffffffu, in);
      if (lane == 0) s_wcnt[warp] = __popc(bal);
      sync();
      int before = 0, total = 0;
      for (int w2 = 0; w2 < NW; ++w2) {
        before += w2 < warp ? s_wcnt[w2] : 0;
        total += s_wcnt[w2];
      }
      if (in) {
        const int pos = before + __popc(bal & ((1u << lane) - 1u));
        s_list[pos] = tid;
        s_plab[pos] = lab;
      }
      sync();
      for (int sub = 0; sub < total; sub += gather) {
        const int cnt = min(gather, total - sub);
        for (int q = tid; q < cnt * per; q += NT) {
          const int i = q / per, o = (q - i * per) * gran;
          copy_chunk((unsigned char*)stage + i * row_bytes + o,
                     xb + (base + s_list[sub + i]) * row_bytes + o, gran);
        }
        cdrs::cp_async_commit();
        cdrs::cp_async_wait<0>();
        sync();
        add_rows<NW>(s_slab, s_plab + sub, cnt, s0, ns, d, warp,
                     [&](int rr, int f) { return to_f(stage[rr * d + f]); });
        sync();
      }
    }
    sync();
    for (int e = tid; e < ns * d; e += NT) my_part[(int64_t)s0 * d + e] = s_slab[e];
    sync();
  }
}

// Where the passes' pieces go in the `free` bytes from offset 0 of shared
// memory: the clusters' sums, then `gather` staged rows, then the lists of
// NT rows and labels.  False when not even one cluster fits.
inline bool pass_layout(size_t free, int d, int esz, int nt, int& slab, int& gather,
                        int& off_stage, int& off_list) {
  auto a16 = [](size_t v) { return (v + 15) & ~(size_t)15; };
  const size_t lists = a16((size_t)2 * nt * 4);
  gather = 64;
  while (gather > 1 && free < lists + a16((size_t)gather * d * esz) + a16((size_t)4 * d))
    gather /= 2;
  const size_t used = lists + a16((size_t)gather * d * esz);
  const size_t room = free > used ? free - used : 0;
  slab = (int)((room > 16 ? room - 16 : 0) / (4 * (size_t)d));
  off_stage = (int)a16((size_t)slab * d * 4);
  off_list = off_stage + (int)a16((size_t)gather * d * esz);
  return slab >= 1;
}


// Starts the copy of `rows` rows of `bytes` bytes (source stride src_stride)
// into shared rows of dst_stride bytes, `gran` bytes a copy.
__device__ __forceinline__ void stage_rows(unsigned char* dst, int dst_stride,
                                           const unsigned char* src, int64_t src_stride,
                                           int bytes, int rows, int gran) {
  const int per = bytes / gran;
  const int total = rows * per;
  for (int q = threadIdx.x; q < total; q += kThreads) {
    const int r = q / per, o = (q - r * per) * gran;
    copy_chunk(dst + r * dst_stride + o, src + r * src_stride + o, gran);
  }
}

// ---- the kernel

// MINB blocks an SM: 2 (at most 128 registers) when all of c is resident and
// a block's shared memory leaves room for two, 1 for the chunk ring, whose
// shared memory holds one block anyway and whose products then keep more of
// their operands in registers.
template <typename T, int WN, int MINB>
__global__ void __launch_bounds__(kThreads, MINB) lloyd_general_kernel(const Params p) {
  constexpr int BN = 16 * WN;   // centroids a tile: two warps of 8 WN
  constexpr int KS = depth<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_c = (float*)(smem + p.off_c);
  float* s_csq = (float*)(smem + p.off_csq);
  int* s_cnt = (int*)(smem + p.off_cnt);
  int* s_lab = (int*)(smem + p.off_lab);
  float* s_bv = (float*)(smem + p.off_best);
  int* s_bj = (int*)(s_bv + 2 * kBM);
  float* s_acc = (float*)(smem + p.off_acc);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int d = p.d, k = p.k;
  const int64_t kd = (int64_t)k * d;
  const int64_t ntiles = (p.n + kBM - 1) / kBM;
  const int64_t t0 = (int64_t)blockIdx.x * p.tiles_per_block;
  const int64_t t1 = min64(t0 + p.tiles_per_block, ntiles);
  const int my = t1 > t0 ? (int)(t1 - t0) : 0;
  const int ntc = p.kp / BN;
  constexpr int esz = (int)sizeof(T);
  const unsigned char* xb = (const unsigned char*)p.x;

  csplit_c<T>(p, BN);
  for (int j = tid; j < k; j += kThreads) s_cnt[j] = 0;
  if (p.inline_stats)
    for (int64_t e = tid; e < kd; e += kThreads) s_acc[e] = 0.f;
  for (int j = tid; j < p.kp; j += kThreads)
    s_csq[j] = j < k ? sq_norm(p.c + (int64_t)j * d, d) : INFINITY;
  cooperative_groups::this_grid().sync();   // csplit is whole

  auto stage_x = [&](unsigned char* dst, int64_t tile, int f0, int w) {
    const int64_t r0 = tile * kBM;
    const int rows = (int)min64(kBM, p.n - r0);
    stage_rows(dst, p.xs * esz, xb + (r0 * d + f0) * esz, (int64_t)d * esz, w * esz, rows,
               p.xgran);
  };
  // Starts the copy of `bytes` contiguous bytes of csplit from a chunk on.
  auto stage_c = [&](unsigned char* dst, int64_t chunk, int bytes) {
    const unsigned char* src = (const unsigned char*)p.csplit + chunk * p.cchunk;
    for (int q = tid * 16; q < bytes; q += kThreads * 16) cdrs::cp_async16(dst + q, src + q, 16);
  };

  float acc[2][WN][4];
  float bv[4];
  int bj[4];
  const int xoff = (wm * 32 + g) * p.xs + (esz == 4 ? t : 2 * t);
  const int coff = (wn * WN * 8 + g) * p.cs + (esz == 4 ? t : 2 * t);

  // acc (+)= x_tile[:, :w] . c_tile[:, :w]^T for the warp's block.
  auto zero_acc = [&]() {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < WN; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;
  };
  auto products = [&](const T* xt, const float* ct, int w) {
    const int full = w / KS;
    for (int s = 0; s < full; ++s)
      mma_step<WN, false>(acc, xt + xoff, p.xs, ct + coff, p.cs, s * KS, w, t);
    if (full * KS < w) mma_step<WN, true>(acc, xt + xoff, p.xs, ct + coff, p.cs, full * KS, w, t);
  };
  // Running best of the rows over centroid tile jt: strict < over increasing j.
  auto rank = [&](int jt) {
#pragma unroll
    for (int nt = 0; nt < WN; ++nt) {
      const int j = jt * BN + wn * WN * 8 + nt * 8 + 2 * t;
      const float c0 = s_csq[j], c1 = s_csq[j + 1];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = 2 * mt + h;
          const float v0 = c0 - 2.f * acc[mt][nt][2 * h];
          const float v1 = c1 - 2.f * acc[mt][nt][2 * h + 1];
          if (v0 < bv[q]) { bv[q] = v0; bj[q] = j; }
          if (v1 < bv[q]) { bv[q] = v1; bj[q] = j + 1; }
        }
    }
  };
  auto reset_best = [&]() {
#pragma unroll
    for (int q = 0; q < 4; ++q) { bv[q] = INFINITY; bj[q] = 0; }
  };
  // Labels of tile `tile`: merge the four lanes of a row, then the two
  // centroid warps, by (distance, index); store, count, and (inline) add
  // the tile's rows from `xt`.
  auto finish = [&](int64_t tile, const T* xt) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float v = bv[q];
      int j = bj[q];
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, o);
        const int oj = __shfl_xor_sync(0xffffffffu, j, o);
        if (ov < v || (ov == v && oj < j)) { v = ov; j = oj; }
      }
      if (t == 0) {
        const int r = wm * 32 + (q >> 1) * 16 + (q & 1) * 8 + g;
        s_bv[wn * kBM + r] = v;
        s_bj[wn * kBM + r] = j;
      }
    }
    __syncthreads();
    if (tid < kBM) {
      const float v0 = s_bv[tid], v1 = s_bv[kBM + tid];
      const int j0 = s_bj[tid], j1 = s_bj[kBM + tid];
      const int lab = (v1 < v0 || (v1 == v0 && j1 < j0)) ? j1 : j0;
      const int64_t row = tile * kBM + tid;
      if (row < p.n && p.labels != nullptr) p.labels[row] = lab;
      const bool counted = row < p.n_valid;
      if (counted) atomicAdd(&s_cnt[lab], 1);
      s_lab[tid] = counted ? lab : -1;
    }
    __syncthreads();
    if (xt != nullptr)
      add_rows<kWarps>(s_acc, s_lab, kBM, 0, k, d, warp,
                       [&](int r, int f) { return to_f(xt[r * p.xs + f]); });
  };

  if (p.resident) {
    // All of c once; x tiles through a ring of S buffers, S - 1 in flight.
    const int S = p.stages;
    const int xtile = kBM * p.xs * esz;
    stage_c((unsigned char*)s_c, 0, ntc * p.cchunk);
    for (int s = 0; s < S - 1; ++s) {
      if (s < my) stage_x(smem + s * xtile, t0 + s, 0, d);
      cdrs::cp_async_commit();
    }
    for (int i = 0; i < my; ++i) {
      cdrs::cp_async_wait_dyn(S - 2);   // tile i is in
      __syncthreads();                  // and every warp is done with tile i - 1
      const int nx = i + S - 1;
      if (nx < my) stage_x(smem + (nx % S) * xtile, t0 + nx, 0, d);
      cdrs::cp_async_commit();
      const T* xt = (const T*)(smem + (i % S) * xtile);
      reset_best();
      for (int jt = 0; jt < ntc; ++jt) {
        zero_acc();
        products(xt, (const float*)((const unsigned char*)s_c + (size_t)jt * p.cchunk), d);
        rank(jt);
      }
      finish(t0 + i, p.inline_stats ? xt : nullptr);
    }
  } else {
    // Steps (tile, centroid tile, feature chunk), each one slot of (x chunk,
    // c chunk) of a two-slot ring: step s + 1 loads while step s computes.
    const int64_t nsteps = (int64_t)my * ntc * p.nfc;
    auto stage_step = [&](int64_t s) {
      const int fc = (int)(s % p.nfc);
      const int64_t q = s / p.nfc;
      const int jt = (int)(q % ntc);
      const int64_t i = q / ntc;
      unsigned char* slot = smem + (s & 1) * p.slot_bytes;
      const int f0 = fc * p.dc, w = min(p.dc, d - f0);
      stage_x(slot, t0 + i, f0, w);
      stage_c(slot + p.slot_c, (int64_t)jt * p.nfc + fc, p.cchunk);
    };
    if (nsteps > 0) stage_step(0);
    cdrs::cp_async_commit();
    int64_t s = 0;
    for (int i = 0; i < my; ++i) {
      reset_best();
      for (int jt = 0; jt < ntc; ++jt) {
        for (int fc = 0; fc < p.nfc; ++fc, ++s) {
          __syncthreads();   // every warp is done with step s - 1's slot
          if (s + 1 < nsteps) stage_step(s + 1);
          cdrs::cp_async_commit();
          cdrs::cp_async_wait<1>();   // step s is in
          __syncthreads();
          const unsigned char* slot = smem + (s & 1) * p.slot_bytes;
          const int f0 = fc * p.dc;
          if (fc == 0) zero_acc();   // later chunks add to the accumulators
          products((const T*)slot, (const float*)(slot + p.slot_c), min(p.dc, d - f0));
          if (fc == p.nfc - 1) rank(jt);
        }
      }
      finish(t0 + i, nullptr);
    }
  }
  cdrs::cp_async_wait<0>();
  __syncthreads();

  // The block's partial, written once.
  float* my_part = p.part_sums + (int64_t)blockIdx.x * kd;
  if (p.inline_stats) {
    for (int64_t e = tid; e < kd; e += kThreads) my_part[e] = s_acc[e];
  } else {
    // Passes over the block's counted rows, each owning p.slab clusters in
    // the shared memory the tiles used.
    const int64_t r1 = min64(t1 * kBM, p.n_valid);
    stat_passes<T, kThreads>(smem, p.off_stage, p.off_list, s_bj, p.labels, xb,
                                           t0 * kBM, r1, k, d, p.slab, p.gather, p.xgran,
                                           my_part, tid, [] { __syncthreads(); });
  }
  for (int j = tid; j < k; j += kThreads) p.part_counts[(int64_t)blockIdx.x * k + j] = s_cnt[j];

  cooperative_groups::this_grid().sync();

  // Every block sums its share of the cells over the partials, blocks in order.
  const int nb = gridDim.x;
  const int64_t gt = (int64_t)blockIdx.x * kThreads + tid, gs = (int64_t)nb * kThreads;
  for (int64_t e = gt; e < kd; e += gs) {
    float sum = 0.f;
#pragma unroll 8
    for (int b = 0; b < nb; ++b) sum += __ldcg(p.part_sums + (int64_t)b * kd + e);
    p.sums[e] = sum;
  }
  for (int64_t j = gt; j < k; j += gs) {
    int sum = 0;
    for (int b = 0; b < nb; ++b) sum += __ldcg(p.part_counts + (int64_t)b * k + j);
    p.counts[j] = (float)sum;
  }
}

// ---- host side

size_t a16(size_t v) { return (v + 15) & ~(size_t)15; }
int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Largest copy size (16, 8, 4 or 2 bytes) that divides both the row size
// and the address.
int gran_of(const void* ptr, int64_t row_bytes) {
  int g = 16;
  while (g > 2 && (((uintptr_t)ptr % g) != 0 || row_bytes % g != 0)) g >>= 1;
  return g;
}

// The shape's layout: all of c resident when it fits beside a ring of at
// least two x tiles, else the chunk ring with the widest feature chunk
// that fits (split evenly).  Row strides are padded to 4 mod 8 words (f32
// fragments) or 8 mod 16 (bf16 pairs), so fragment loads hit 32 banks.
template <typename T>
bool plan(int d, int k, int wn, Params& p, size_t& smem) {
  const int esz = (int)sizeof(T), ks = depth<T>(), pad = esz == 4 ? 4 : 8;
  const int bn = 16 * wn, dp = round_up(d, ks);
  p.kp = round_up(k, bn);
  const size_t tail = a16((size_t)p.kp * 4) + a16((size_t)k * 4) + a16(kLabChunk * 4)
                    + a16(2 * kBM * 8);   // |c|^2, counts, labels, best pairs
  const size_t kd_bytes = (size_t)k * d * 4;
  auto offsets = [&](size_t head, size_t acc) {
    p.off_csq = (int)head;
    p.off_cnt = p.off_csq + (int)a16((size_t)p.kp * 4);
    p.off_lab = p.off_cnt + (int)a16((size_t)k * 4);
    p.off_best = p.off_lab + (int)a16(kLabChunk * 4);
    p.off_acc = p.off_best + (int)a16(2 * kBM * 8);
    smem = (size_t)p.off_acc + acc;
    // The passes' layout in [0, off_cnt), free once the tiles are done.
    pass_layout((size_t)p.off_cnt, d, esz, kThreads, p.slab, p.gather,
                              p.off_stage, p.off_list);
  };
  p.xs = dp + pad;
  p.cs = dp + pad;
  const size_t xt = (size_t)kBM * p.xs * esz;   // a multiple of 16
  const int parts = esz == 4 ? 2 : 1;   // f32: c's high and low parts
  p.cchunk = parts * bn * p.cs * 4;      // a multiple of 16
  const size_t cres = (size_t)(p.kp / bn) * p.cchunk;
  for (int inl = kd_bytes <= kInlineBytes ? 1 : 0; inl >= 0; --inl) {
    const size_t acc = inl ? a16(kd_bytes) : 0;
    const size_t fixed = cres + tail + acc;
    int stages = (int)(kXRingBytes / xt);
    stages = stages < 2 ? 2 : (stages > kMaxStages ? kMaxStages : stages);
    while (stages > 2 && fixed + stages * xt > kSmemMax) --stages;
    if (fixed + stages * xt <= kSmemMax) {
      p.resident = 1;
      p.stages = stages;
      p.dc = d;
      p.nfc = 1;
      p.inline_stats = inl;
      p.off_c = (int)(stages * xt);
      offsets(p.off_c + cres, acc);
      return p.inline_stats || p.slab >= 1;
    }
  }
  // Chunk ring: two slots of (128 x (dc + pad) of x, bn x (dc + pad) of c).
  if (tail >= kSmemMax) return false;
  const size_t per = 2 * ((size_t)kBM * esz + (size_t)parts * bn * 4);   // bytes a feature
  int dcmax = (int)((kSmemMax - tail - 64) / per) - pad;
  dcmax = dcmax / ks * ks;
  if (dcmax < ks) return false;
  p.nfc = (dp + dcmax - 1) / dcmax;
  p.dc = round_up((dp + p.nfc - 1) / p.nfc, ks);
  p.nfc = (d + p.dc - 1) / p.dc;
  p.xs = p.dc + pad;
  p.cs = p.dc + pad;
  p.cchunk = parts * bn * p.cs * 4;
  p.slot_c = (int)a16((size_t)kBM * p.xs * esz);
  p.slot_bytes = p.slot_c + p.cchunk;
  p.resident = 0;
  p.stages = 2;
  p.inline_stats = 0;
  p.off_c = 0;
  offsets(2 * (size_t)p.slot_bytes, 0);
  return smem <= kSmemMax && p.slab >= 1;
}

int wn_for(int k) { return k > 64 ? 8 : 4; }

template <typename T, int WN, int MINB>
cudaError_t launch(const Args& a, Params p, size_t smem) {
  auto kern = lloyd_general_kernel<T, WN, MINB>;
  static size_t smem_set[32] = {};
  static size_t occ_smem = 0;   // the last shared-memory size asked, and its answer
  static int occ_blocks = 0;
  cudaError_t err = cdrs::set_smem_once(kern, smem, smem_set);
  if (err != cudaSuccess) return err;
  if (occ_smem != smem) {
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, kThreads, smem);
    if (err != cudaSuccess) return err;
    occ_smem = smem;
    occ_blocks = blocks;
  }
  if (occ_blocks < 1) return cudaErrorInvalidConfiguration;
  const int64_t ntiles = (a.n + kBM - 1) / kBM;
  int64_t grid = (int64_t)a.sms * occ_blocks;
  if (grid > a.nb) grid = a.nb;
  if (grid > ntiles) grid = ntiles;
  if (grid < 1) grid = 1;
  p.tiles_per_block = (ntiles + grid - 1) / grid;
  if (p.tiles_per_block > 0) grid = (ntiles + p.tiles_per_block - 1) / p.tiles_per_block;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)kern, dim3((unsigned)grid), dim3(kThreads),
                                    args, smem, a.stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t general_path(const Args& a) {
  Params p{};
  size_t smem = 0;
  const int wn = wn_for(a.k);
  if (!plan<T>(a.d, a.k, wn, p, smem)) return cudaErrorInvalidValue;
  if (!p.inline_stats && a.labels == nullptr) return cudaErrorInvalidValue;
  p.x = a.x;
  p.c = a.c;
  p.n = a.n;
  p.n_valid = a.n_valid;
  p.d = a.d;
  p.k = a.k;
  p.labels = a.labels;
  p.part_sums = a.part_sums;
  p.part_counts = a.part_counts;
  p.sums = a.sums;
  p.counts = a.counts;
  p.xgran = gran_of(a.x, (int64_t)a.d * (int64_t)sizeof(T));
  // The wrapper's extra floats past the partials, from a 16-byte boundary.
  p.csplit = a.part_sums + (((int64_t)a.nb * a.k * a.d + 3) & ~(int64_t)3);
  if (p.resident) return wn == 8 ? launch<T, 8, 2>(a, p, smem) : launch<T, 4, 2>(a, p, smem);
  return wn == 8 ? launch<T, 8, 1>(a, p, smem) : launch<T, 4, 1>(a, p, smem);
}

}  // namespace gen

// -------------------------------------------------- general path on wgmma

namespace wgh {

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point (the
// library links no driver library of its own).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult got{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr,
                                                             12000, cudaEnableDefault, &got);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                                    cudaEnableDefault, &got);
#endif
    if (err == cudaSuccess && got == cudaDriverEntryPointSuccess) fn = (EncodeTiled)ptr;
  }
  return fn;
}

template <typename T>
cudaError_t path(const Args& a, const wg::Cfg& cfg) {
  constexpr int esz = (int)sizeof(T);
  wg::Params p{};
  size_t smem = 0;
  if (!wg::layout(a.d, a.k, esz, cfg, p, smem)) return cudaErrorInvalidValue;
  if (a.labels == nullptr || a.order == nullptr) return cudaErrorInvalidValue;
  if (((uintptr_t)a.x & 15) != 0) return cudaErrorMisalignedAddress;   // TMA's base
  if (a.n > (int64_t)INT32_MAX - wg::kBM) return cudaErrorInvalidValue;   // TMA's row coordinate
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  // x as TMA reads it: boxes of kBM rows x cb bytes, swizzled over cb-byte
  // rows; features past d and rows past n come in as zeros.
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)a.d, (cuuint64_t)(a.n > 0 ? a.n : 1)};
  const cuuint64_t strides[1] = {(cuuint64_t)a.d * esz};
  const cuuint32_t box[2] = {(cuuint32_t)(p.cb / esz), (cuuint32_t)wg::kBM};
  const cuuint32_t unit[2] = {1, 1};
  const CUtensorMapSwizzle swizzle = p.cb == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                   : (p.cb == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                 : CU_TENSOR_MAP_SWIZZLE_32B);
  if (enc(&map, esz == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
          2, const_cast<void*>(a.x), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
          swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  p.x = a.x;
  p.c = a.c;
  p.n = a.n;
  p.n_valid = a.n_valid;
  p.d = a.d;
  p.k = a.k;
  p.labels = a.labels;
  p.part_sums = a.part_sums;
  p.part_counts = a.part_counts;
  p.sums = a.sums;
  p.counts = a.counts;
  p.bar = a.ticket;
  p.order = a.order;
  // The wrapper's extra floats past the partials, from a 16-byte boundary.
  p.csplit = (unsigned char*)(a.part_sums + (((int64_t)a.nb * a.k * a.d + 3) & ~(int64_t)3));

  auto kern = wg::lloyd_wgmma_kernel<T>;
  static size_t smem_set[32] = {};
  static size_t occ_smem = 0;   // the last shared-memory size asked, and its answer
  static int occ_blocks = 0;
  cudaError_t err = cdrs::set_smem_once(kern, smem, smem_set);
  if (err != cudaSuccess) return err;
  if (occ_smem != smem) {
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, wg::kThreads, smem);
    if (err != cudaSuccess) return err;
    occ_smem = smem;
    occ_blocks = blocks;
  }
  if (occ_blocks < 1) return cudaErrorInvalidConfiguration;
  // Persistent: one block an SM, each taking a contiguous run of row tiles,
  // the runs within one tile of each other.
  p.ntiles = (a.n + wg::kBM - 1) / wg::kBM;
  int64_t grid = a.sms;
  if (grid > p.ntiles) grid = p.ntiles;
  if (grid < 1) grid = 1;
  if (grid > a.nb) return cudaErrorInvalidValue;
  void* args[] = {&p, &map};
  err = cudaLaunchCooperativeKernel((const void*)kern, dim3((unsigned)grid),
                                    dim3(wg::kThreads), args, smem, a.stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace wgh

// The plan ops/lloyd.py passes: {path (0 small, 1 mma_sync, 2 wgmma), then
// the wgmma path's cstages, xstages, resident}.
enum { kPathSmall = 0, kPathMmaSync = 1, kPathWgmma = 2 };

wg::Cfg cfg_of(const int* plan) { return wg::Cfg{plan[1], plan[2], plan[3]}; }

template <typename T>
int launch(const Args& a, const int* plan) {
  if (a.n < 0 || a.d < 1 || a.k < 1 || a.nb < 2 || a.sms < 1 || a.n_valid < 0 || a.n_valid > a.n)
    return (int)cudaErrorInvalidValue;
  switch (plan[0]) {
    case kPathSmall:
      if (a.d > 8 || a.k > 16) return (int)cudaErrorInvalidValue;
      return (int)small_path<T>(a);
    case kPathMmaSync: return (int)gen::general_path<T>(a);
    case kPathWgmma: return (int)wgh::path<T>(a, cfg_of(plan));
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x (n, d) row-major f32 or bf16; c (k, d) f32 (already rounded to x's type;
// |c|^2 is taken in the kernel); labels (n,) int32 or NULL (the general
// paths need a buffer where cdrs_lloyd_plan_info's out[1] says so); part_sums
// (nb * k * d + cdrs_lloyd_plan_info's out[0]) f32 and part_counts (nb * k)
// int32 scratch; ticket one uint32, zero before the first launch (each
// launch leaves it zero); sums (k, d) f32; counts (k,) f32.  nb >= 2 is the
// partial capacity in blocks (2 x SMs); sms the device's SM count; plan
// four ints (cfg_of); order (n,) int32 scratch on the wgmma path (its sums
// sort each block's rows by cluster), else NULL.
// Returns a cudaError_t code (0 = launched).
int cdrs_lloyd_f32(const void* x, const void* c, int64_t n, int64_t n_valid,
                   int d, int k, void* labels, void* part_sums, void* part_counts,
                   void* ticket, void* sums, void* counts, int nb, int sms, void* stream,
                   const int* plan, void* order) {
  const Args a{x, (const float*)c, n, n_valid, d, k, (int*)labels,
               (float*)part_sums, (int*)part_counts, (unsigned*)ticket, (float*)sums,
               (float*)counts, nb, sms, (cudaStream_t)stream, (int*)order};
  return launch<float>(a, plan);
}

int cdrs_lloyd_bf16(const void* x, const void* c, int64_t n, int64_t n_valid,
                    int d, int k, void* labels, void* part_sums, void* part_counts,
                    void* ticket, void* sums, void* counts, int nb, int sms, void* stream,
                    const int* plan, void* order) {
  const Args a{x, (const float*)c, n, n_valid, d, k, (int*)labels,
               (float*)part_sums, (int*)part_counts, (unsigned*)ticket, (float*)sums,
               (float*)counts, nb, sms, (cudaStream_t)stream, (int*)order};
  return launch<__nv_bfloat16>(a, plan);
}

// What a plan needs at a shape: out[0] the floats part_sums needs past
// nb * k * d (c in the products' layout, from a 16-byte boundary; on the
// wgmma path then |c|^2), out[1] 1 when a call stores labels even without
// with_labels (sums not inline: passes over the block's rows, or on the
// wgmma path its rows sorted by cluster, which also takes the n-long order
// scratch), out[2] the bytes of shared memory a block takes.  Returns 0, or -1 when the plan cannot serve the shape.
int cdrs_lloyd_plan_info(int d, int k, int bf16, const int* plan, int64_t* out) {
  out[0] = out[1] = out[2] = 0;
  if (d < 1 || k < 1) return -1;
  if (plan[0] == kPathSmall) return d <= 8 && k <= 16 ? 0 : -1;
  size_t smem = 0;
  if (plan[0] == kPathWgmma) {
    wg::Params p{};
    if (!wg::layout(d, k, bf16 ? 2 : 4, cfg_of(plan), p, smem)) return -1;
    out[0] = (int64_t)p.ntc * p.nfc * (p.chunk / 4) + p.kp + 4;   // c, then |c|^2
    out[1] = 1;
    out[2] = (int64_t)smem;
    return 0;
  }
  gen::Params p{};
  const int wn = gen::wn_for(k);
  const bool ok = bf16 ? gen::plan<__nv_bfloat16>(d, k, wn, p, smem)
                       : gen::plan<float>(d, k, wn, p, smem);
  if (!ok) return -1;
  out[0] = (int64_t)(p.kp / (16 * wn)) * p.nfc * (p.cchunk / 4) + 4;
  out[1] = p.inline_stats ? 0 : 1;
  out[2] = (int64_t)smem;
  return 0;
}

}  // extern "C"
