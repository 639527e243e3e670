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
// * General path (every other call: config 3's 10M x 128, k = 1024, and
//   entry()'s d = 5, k = 64).  Counting into one table in device memory
//   made every passing compare a global atomic; here each block counts into
//   a private table in shared memory over one slice of the features (see
//   "general path" below), staged per warp (tiles in flight, no block
//   barrier between folds), and the tables meet in device memory once a
//   block.  What sets its pace at d = 128 (tools/seg_breakdown.py): the
//   staging of strided row slices, 32 bytes a row and block in f32 and 16
//   in bf16.  Tensor copies (TMA) of (rows x slice) boxes move them faster
//   than cp.async copies, whose requests share the load/store pipe with
//   the counting, but take about the same time a box row at 16 bytes as
//   at 32, so bf16 rows read at half f32's rate.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tile.cuh"

namespace {

using cdrs::kStages;
using cdrs::to_f;

struct Args {
  const void* x;
  const int* labels;
  const float* thr;    // (2, k, d)
  const float* gthr;   // (2, d) or NULL
  int64_t n;
  int d, k;
  int* out;            // (k*2d [+ 2d]) : per-cluster table, then the global one
  int* part;           // small path: (C, grid) block partials; general: the zeroed acc
  unsigned* ticket;    // small path: one; general: one a slice; zero between launches
  int nb;              // small path: partial capacity (blocks); general: tickets
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
//
// Private tables by feature slice.  The d features are cut into slices of S
// (the wrapper's plan, ops/seg_count.plan, picks S so that a block's table
// fits in shared memory); block b takes slice b % nslices over the rows of
// group b / nslices, so the blocks of one group read the same rows at once.
// A warp stages its tiles by one tensor copy of a (WR x S) box where a box
// row and the row pitch are whole 16-byte units (d = 128 at S = 8), else
// by cp.async copies of each row's slice.
// Its table holds, per (cluster, slice feature), both thresholds (a float2)
// and the two counts packed as 16-bit halves of one word, so a passing
// element costs one shared integer atomic; before a half could pass kHalf
// the halves fold into an int32 table.  At the end the block adds its
// nonzero int32 cells into `acc` (zero between launches) with integer
// atomics; the last block of a slice to take its ticket copies the slice's
// cells to `out` and zeroes them again, so the call is one launch and needs
// no memset.  Labels are read once a slice (d / S times in all).  Past the
// reach of any slice's table (k above about 10,000) the "global" path
// counts into the zeroed output with global atomics, as before.

enum Path { kSmall = 0, kRows = 1, kPairs = 2, kGlobal = 3 };

// A block's dynamic shared memory may not pass this (ops/seg_count.SMEM_MAX:
// the H100's 227 KB less room for the static arrays).
constexpr size_t kSmemMax = 232448 - 1024;
// Rows a 16-bit half may count before it folds into the int32 table.
constexpr int kHalf = 65535;

template <typename T, int S, bool ROWS>
struct Gen {
  // ROWS (d = S <= 8, one slice): a lane takes a row and its S features,
  // and a warp tile is 32 whole rows, one contiguous run of x.  Else S / 2
  // lanes take a row, two adjacent features each (one 8- or 4-byte read of
  // x, one 16-byte read of their thresholds, one read of the label for
  // two elements), and a warp tile is WR rows of the slice's S columns
  // (32 bytes a row at S = 8).
  static constexpr int LPR = ROWS ? 1 : (S > 1 ? S / 2 : 1);      // lanes a row
  static constexpr int F = S / LPR;                               // features a lane
  static constexpr int THREADS = ROWS && S <= 5 ? 1024 : 512;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int WR = ROWS ? 32 : 32 * 4 / (int)sizeof(T);  // rows a warp tile
  static constexpr int STEP = 32 / LPR;                           // rows a warp step
  static constexpr int STAGES = ROWS ? 4 : kStages;               // tiles in flight a warp
  static constexpr int XBYTES = WR * S * (int)sizeof(T);
  static constexpr int TILE = XBYTES + WR * 4;                    // x, then the labels
  static_assert(XBYTES % 16 == 0, "tiles must keep 16-byte alignment");
};

// Dynamic shared memory of a block: 128 bytes to align the staging rings
// for the tensor copies, its warps' rings, then (SMEM) the table: k*S
// float2 thresholds, k*2S int32 counts, k*S packed counts.
template <typename T, int S, bool ROWS, bool SMEM>
size_t gen_smem(int k) {
  using G = Gen<T, S, ROWS>;
  return 128 + (size_t)G::WARPS * G::STAGES * G::TILE + (SMEM ? (size_t)20 * k * S : 0);
}

// One warp's tensor copy of a (WR rows x S features) box of x into its
// staging ring, completing on the tile's mbarrier (issued by one lane).
__device__ __forceinline__ void tma_box(unsigned dst, const CUtensorMap* map, int col, int row,
                                        unsigned bar, unsigned bytes) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"((uint64_t)map), "r"(col), "r"(row), "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}\n" :: "r"(bar), "r"(parity) : "memory");
}

// Two adjacent elements of a staged tile (8- or 4-byte aligned) as floats.
__device__ __forceinline__ float2 load2(const float* p) { return *(const float2*)p; }
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  const __nv_bfloat162 b = *(const __nv_bfloat162*)p;
  return make_float2(__bfloat162float(b.x), __bfloat162float(b.y));
}

// Starts the copy of `rows` row slices of `bytes` bytes each, `pitch` bytes
// apart in x, into rows `dpitch` bytes apart at `dst`, by the lanes of one
// warp: `chunk`-byte cp.async copies (16, 8 or 4), or 2-byte loads where
// nothing wider divides the offsets.
__device__ __forceinline__ void stage_slice(unsigned char* dst, const unsigned char* src,
                                            int rows, int64_t pitch, int bytes, int dpitch,
                                            int chunk) {
  const int lane = threadIdx.x & 31;
  const int per = bytes / chunk;
  for (int q = lane; q < rows * per; q += 32) {
    const int r = q / per, p = q - r * per;
    unsigned char* dq = dst + r * dpitch + p * chunk;
    const unsigned char* sq = src + r * pitch + p * chunk;
    switch (chunk) {
      case 16: cdrs::cp_async16(dq, sq, 16); break;
      case 8: cdrs::cp_async8(dq, sq); break;
      case 4: cdrs::cp_async4(dq, sq); break;
      default: *(uint16_t*)dq = *(const uint16_t*)sq; break;
    }
  }
}

// SMEM false (k too large for any slice's table): the same walk, counting
// straight into `acc` (then the output itself, zeroed by the wrapper) with
// global atomics against thresholds read from device memory; no tickets.
template <typename T, int S, bool ROWS, bool SMEM>
__global__ void __launch_bounds__(Gen<T, S, ROWS>::THREADS, 1)
seg_slice_kernel(const T* __restrict__ x, const int* __restrict__ labels,
                 const float* __restrict__ thr, const float* __restrict__ gthr, int64_t n,
                 int d, int k, int nslices, int64_t group_tiles, int chunk, bool lab16,
                 bool tma, const __grid_constant__ CUtensorMap map,
                 int* __restrict__ acc, unsigned* __restrict__ tickets,
                 int* __restrict__ out) {
  using G = Gen<T, S, ROWS>;
  constexpr int THREADS = G::THREADS, WARPS = G::WARPS, WR = G::WR, LPR = G::LPR, F = G::F;
  constexpr int STAGES = G::STAGES;
  constexpr int ESZ = (int)sizeof(T);
  constexpr unsigned FULL = 0xffffffffu;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_g[2 * S];
  __shared__ bool s_last;
  __shared__ __align__(8) uint64_t s_bar[ROWS ? 1 : WARPS * STAGES];   // tensor copies
  unsigned char* smem = smem_raw + ((128 - ((unsigned)__cvta_generic_to_shared(smem_raw) & 127)) & 127);
  float2* s_thr = (float2*)(smem + WARPS * STAGES * G::TILE);    // (k, S)
  int* s_cnt = (int*)(s_thr + (SMEM ? k * S : 0));               // (k, 2, S)
  unsigned* s_pk = (unsigned*)(s_cnt + (SMEM ? 2 * k * S : 0));  // (k, S), rank 1 high

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int c = blockIdx.x % nslices;
  const int64_t grp = blockIdx.x / nslices;
  const int groups = gridDim.x / nslices;
  const int col0 = c * S;
  const int w = d - col0 < S ? d - col0 : S;   // this slice's width
  const int64_t kd = (int64_t)k * d;
  const bool has_g = gthr != nullptr;
  for (int e = t; e < 2 * S; e += THREADS) s_g[e] = 0;
  if constexpr (SMEM) {
    for (int e = t; e < k * S; e += THREADS) {
      const int j = e / S, f = e - j * S;
      float2 v = make_float2(0.f, 0.f);
      if (f < w) {
        const int64_t o = (int64_t)j * d + col0 + f;
        v = make_float2(__ldg(thr + o), __ldg(thr + kd + o));
      }
      s_thr[e] = v;
      s_pk[e] = 0u;
      s_cnt[2 * e] = 0;
      s_cnt[2 * e + 1] = 0;
    }
  }
  // A lane's features: fb, ..., fb + F - 1 of the slice, fixed for the call,
  // so their global thresholds and counts live in registers.
  const int fb = (lane % LPR) * F;
  float gt[2 * F];
  int gc[2 * F];
#pragma unroll
  for (int q = 0; q < F; ++q) {
    const bool in = has_g && fb + q < w;
    gt[q] = in ? gthr[col0 + fb + q] : 0.f;
    gt[F + q] = in ? gthr[d + col0 + fb + q] : 0.f;
    gc[q] = gc[F + q] = 0;
  }
  const bool live = fb < w;   // a lane past a narrow last slice counts nothing
  __syncthreads();

  // The group's tiles of WR rows; warp w takes tiles w, w + WARPS, ...
  const int64_t ntiles = (n + WR - 1) / WR;
  const int64_t tile0 = grp * group_tiles;
  const int64_t left = ntiles - tile0;
  const int64_t here = left <= 0 ? 0 : (left < group_tiles ? left : group_tiles);
  const int my_tiles = warp < here ? (int)((here - warp + WARPS - 1) / WARPS) : 0;
  const int most = (int)((here + WARPS - 1) / WARPS);   // the busiest warp's tiles
  unsigned char* wt = smem + warp * (STAGES * G::TILE);
  const unsigned char* xb = (const unsigned char*)x;
  const unsigned bar0 = (unsigned)__cvta_generic_to_shared(s_bar + warp * STAGES);
  if (tma) {
    if (lane == 0) {
      for (int s = 0; s < STAGES; ++s)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar0 + 8 * s) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
  }
  auto first_row = [&](int i) { return (tile0 + warp + (int64_t)i * WARPS) * WR; };
  auto issue = [&](int i) {
    if (i < my_tiles) {
      const int64_t r0 = first_row(i);
      const int rows = n - r0 < WR ? (int)(n - r0) : WR;
      unsigned char* dst = wt + (i % STAGES) * G::TILE;
      if constexpr (ROWS) {
        cdrs::stage_warp_tile(dst, xb + r0 * S * ESZ, rows * S * ESZ, chunk == 16);
      } else if (tma) {
        // Rows past n and columns past d arrive as zeros (never counted).
        if (lane == 0)
          tma_box((unsigned)__cvta_generic_to_shared(dst), &map, col0, (int)r0,
                  bar0 + 8 * (i % STAGES), G::XBYTES);
      } else {
        stage_slice(dst, xb + (r0 * d + col0) * ESZ, rows, (int64_t)d * ESZ, w * ESZ,
                    S * ESZ, chunk);
      }
      // The labels: four a 16-byte copy where they are aligned (a tile
      // starts on a multiple of 32 rows), else one a copy.
      if (lab16) {
        for (int q = lane; 4 * q < rows; q += 32)
          cdrs::cp_async16(dst + G::XBYTES + 16 * q, labels + r0 + 4 * q,
                           rows - 4 * q < 4 ? 4 * (rows - 4 * q) : 16);
      } else {
        for (int r = lane; r < rows; r += 32)
          cdrs::cp_async4(dst + G::XBYTES + 4 * r, labels + r0 + r);
      }
    }
    cdrs::cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);

  // Tiles a warp takes between two folds: a block counts at most kHalf rows.
  constexpr int E = SMEM ? kHalf / (WARPS * WR) : (1 << 30);
  int i = 0;
  for (int e0 = 0; e0 < most; e0 += E) {   // every warp meets the same barriers
    const int stop = my_tiles < e0 + E ? my_tiles : e0 + E;
    for (; i < stop; ++i) {
      cdrs::cp_async_wait<STAGES - 2>();
      if (tma) mbar_wait(bar0 + 8 * (i % STAGES), (i / STAGES) & 1);
      __syncwarp();           // tile i is in; the warp is done with tile i - 1
      issue(i + STAGES - 1);  // into tile i - 1's buffer
      const unsigned char* tb = wt + (i % STAGES) * G::TILE;
      const T* tx = (const T*)tb;
      const int* tl = (const int*)(tb + G::XBYTES);
      const int64_t r0 = first_row(i);
      const int rows = n - r0 < WR ? (int)(n - r0) : WR;
      if constexpr (ROWS) {
        // The lanes of one cluster fold their compares into one atomic by
        // the lowest of them: skewed labels would queue on one word.
        const int lab = lane < rows ? tl[lane] : -1;
        const bool ok = (unsigned)lab < (unsigned)k;
        const unsigned peers = __match_any_sync(FULL, ok ? lab : -1);
        const bool lead = ok && lane == __ffs(peers) - 1;
        const float2* th = s_thr + (ok ? lab : 0) * S;
#pragma unroll
        for (int f = 0; f < S; ++f) {
          const float v = ok ? to_f(tx[lane * S + f]) : 0.f;
          const float2 tt = th[f];
          const unsigned b0 = __ballot_sync(FULL, ok && v <= tt.x);
          const unsigned b1 = __ballot_sync(FULL, ok && v <= tt.y);
          if (lead) {
            const unsigned a = __popc(b0 & peers) | ((unsigned)__popc(b1 & peers) << 16);
            if (a) atomicAdd(s_pk + lab * S + f, a);
          }
          if (has_g && ok) {
            gc[f] += v <= gt[f];
            gc[S + f] += v <= gt[S + f];
          }
        }
      } else {
#pragma unroll
        for (int st = 0; st < WR / G::STEP; ++st) {
          // No branch before the atomics, so the steps' loads can overlap.
          const int r = st * G::STEP + lane / LPR;
          const int lab = r < rows ? tl[r] : -1;
          const bool ok = (unsigned)lab < (unsigned)k && live;
          const int j = ok ? lab : 0;
          float v[F];
          float2 tt[F];
          if constexpr (F == 2) {
            const float2 x2 = load2(tx + r * S + fb);
            v[0] = x2.x;
            v[1] = x2.y;
            if constexpr (SMEM) {
              const float4 t4 = *(const float4*)(s_thr + j * S + fb);
              tt[0] = make_float2(t4.x, t4.y);
              tt[1] = make_float2(t4.z, t4.w);
            }
          } else {
            v[0] = to_f(tx[r * S + fb]);
            if constexpr (SMEM) tt[0] = s_thr[j * S + fb];
          }
#pragma unroll
          for (int q = 0; q < F; ++q) {
            const bool in = ok && fb + q < w;
            if constexpr (SMEM) {
              const unsigned a =
                  in ? (v[q] <= tt[q].x ? 1u : 0u) | (v[q] <= tt[q].y ? 0x10000u : 0u) : 0u;
              if (a) atomicAdd(s_pk + j * S + fb + q, a);
            } else if (in) {
              const int64_t o = (int64_t)j * d + col0 + fb + q;
              const int64_t oc = (int64_t)j * 2 * d + col0 + fb + q;
              if (v[q] <= __ldg(thr + o)) atomicAdd(acc + oc, 1);
              if (v[q] <= __ldg(thr + kd + o)) atomicAdd(acc + oc + d, 1);
            }
            if (has_g) {
              gc[q] += in && v[q] <= gt[q];
              gc[F + q] += in && v[q] <= gt[F + q];
            }
          }
        }
      }
    }
    if constexpr (SMEM) {
      __syncthreads();
      for (int e = t; e < k * S; e += THREADS) {
        const unsigned a = s_pk[e];
        if (a) {
          s_pk[e] = 0u;
          const int j = e / S, f = e - j * S;
          s_cnt[j * 2 * S + f] += (int)(a & 0xffffu);
          s_cnt[j * 2 * S + S + f] += (int)(a >> 16);
        }
      }
      __syncthreads();
    }
  }
  cdrs::cp_async_wait<0>();

  // Global counts: the lanes of one feature reduce by shuffles, then add
  // into the block's 2S counters.
  if (has_g) {
#pragma unroll
    for (int q = 0; q < 2 * F; ++q) {
      int v = gc[q];
#pragma unroll
      for (int o = 16; o >= LPR; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
      if (lane < LPR && v) atomicAdd(&s_g[(q / F) * S + fb + q % F], v);
    }
  }
  __syncthreads();
  // Flush: the block's nonzero cells into acc (integers: exact in any order).
  if constexpr (SMEM) {
    for (int e = t; e < 2 * k * S; e += THREADS) {
      const int v = s_cnt[e];
      if (v) {
        const int j = e / (2 * S), r = (e / S) & 1, f = e % S;
        atomicAdd(acc + (int64_t)j * 2 * d + r * d + col0 + f, v);
      }
    }
  }
  if (has_g) {
    for (int e = t; e < 2 * S; e += THREADS)
      if (s_g[e]) atomicAdd(acc + 2 * kd + (e / S) * d + col0 + e % S, s_g[e]);
  }
  if constexpr (!SMEM) return;   // acc is the output
  // The slice's last block copies its cells out and leaves acc zero.
  __threadfence();
  __syncthreads();
  if (t == 0) s_last = atomicAdd(tickets + c, 1u) == (unsigned)groups - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int e = t; e < 2 * k * w; e += THREADS) {
    const int j = e / (2 * w), rem = e - j * 2 * w, r = rem / w, f = rem - r * w;
    const int64_t o = (int64_t)j * 2 * d + r * d + col0 + f;
    out[o] = __ldcg(acc + o);
    acc[o] = 0;
  }
  if (has_g) {
    for (int e = t; e < 2 * w; e += THREADS) {
      const int64_t o = 2 * kd + (e / w) * d + col0 + e % w;
      out[o] = __ldcg(acc + o);
      acc[o] = 0;
    }
  }
  if (t == 0) tickets[c] = 0u;
}

// cuTensorMapEncodeTiled, looked up once through the runtime's entry-point
// query, so the library links against the runtime alone.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)p;
  }
  return fn;
}

// Resident blocks an SM at one shared-memory size, asked once per size.
struct Occupancy {
  size_t smem[8];
  int blocks[8];
  int used;
};

template <typename Kernel>
cudaError_t blocks_per_sm(Kernel kern, int threads, size_t smem, Occupancy& seen, int& blocks) {
  for (int i = 0; i < seen.used; ++i) {
    if (seen.smem[i] == smem) {
      blocks = seen.blocks[i];
      return cudaSuccess;
    }
  }
  int b = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, kern, threads, smem);
  if (err != cudaSuccess) return err;
  blocks = b > 0 ? b : 1;
  const int slot = seen.used < 8 ? seen.used++ : (int)(smem % 8);
  seen.smem[slot] = smem;
  seen.blocks[slot] = blocks;
  return cudaSuccess;
}

template <typename T, int S, bool ROWS, bool SMEM>
cudaError_t launch_slices(const Args& a) {
  using G = Gen<T, S, ROWS>;
  static size_t smem_set[32] = {};
  static Occupancy seen = {};
  const size_t smem = gen_smem<T, S, ROWS, SMEM>(a.k);
  if (smem > kSmemMax || (ROWS && a.d != S)) return cudaErrorInvalidValue;
  const int nslices = (a.d + S - 1) / S;
  if (SMEM && nslices > a.nb) return cudaErrorInvalidValue;   // one ticket a slice
  auto kern = seg_slice_kernel<T, S, ROWS, SMEM>;
  int per_sm = 0;
  cudaError_t err = cdrs::set_smem_once(kern, smem, smem_set);
  if (err == cudaSuccess) err = blocks_per_sm(kern, G::THREADS, smem, seen, per_sm);
  if (err != cudaSuccess) return err;
  const int64_t ntiles = (a.n + G::WR - 1) / G::WR;
  // As many groups as fill the card once, and none whose warps lack a tile.
  int64_t groups = (int64_t)a.sms * per_sm / nslices;
  const int64_t busy = (ntiles + G::WARPS - 1) / G::WARPS;
  if (groups > busy) groups = busy;
  if (groups < 1) groups = 1;
  const int64_t group_tiles = (ntiles + groups - 1) / groups;
  // Tensor copies of (WR x S) boxes where a box row and the row pitch are
  // whole 16-byte units and x is aligned; else cp.async copies.
  const int esz = (int)sizeof(T);
  const bool tma = !ROWS && SMEM && (S * esz) % 16 == 0 && ((int64_t)a.d * esz) % 16 == 0 &&
                   ((uintptr_t)a.x & 15) == 0;
  CUtensorMap map = {};
  if (tma) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t dims[2] = {(cuuint64_t)a.d, (cuuint64_t)a.n};
    const cuuint64_t pitch[1] = {(cuuint64_t)a.d * esz};
    const cuuint32_t box[2] = {(cuuint32_t)S, (cuuint32_t)G::WR};
    const cuuint32_t unit[2] = {1, 1};
    if (encode(&map, esz == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
               2, const_cast<void*>(a.x), dims, pitch, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  int chunk;
  if (ROWS) {
    chunk = ((uintptr_t)a.x & 15) == 0 ? 16 : 2;
  } else {
    // The widest copy that divides every offset: the row pitch, the slice
    // widths (the last may be narrower) and x's own alignment.
    const uint64_t wlast = (uint64_t)(a.d - (nslices - 1) * S);
    const uint64_t bits = (uint64_t)a.d * esz | (uint64_t)S * esz | wlast * esz
                        | ((uintptr_t)a.x & 15) | 16u;
    chunk = (int)(bits & (~bits + 1));
  }
  kern<<<(unsigned)(groups * nslices), G::THREADS, smem, a.stream>>>(
      (const T*)a.x, a.labels, a.thr, a.gthr, a.n, a.d, a.k, nslices, group_tiles, chunk,
      ((uintptr_t)a.labels & 15) == 0, tma, map, SMEM ? a.part : a.out, a.ticket, a.out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t general_path(const Args& a, int path, int s) {
  if (path == kRows) {
    switch (s) {
      case 1: return launch_slices<T, 1, true, true>(a);
      case 2: return launch_slices<T, 2, true, true>(a);
      case 3: return launch_slices<T, 3, true, true>(a);
      case 4: return launch_slices<T, 4, true, true>(a);
      case 5: return launch_slices<T, 5, true, true>(a);
      case 6: return launch_slices<T, 6, true, true>(a);
      case 7: return launch_slices<T, 7, true, true>(a);
      case 8: return launch_slices<T, 8, true, true>(a);
      default: return cudaErrorInvalidValue;
    }
  }
  if (path == kPairs) {
    switch (s) {
      case 8: return launch_slices<T, 8, false, true>(a);
      case 4: return launch_slices<T, 4, false, true>(a);
      case 2: return launch_slices<T, 2, false, true>(a);
      case 1: return launch_slices<T, 1, false, true>(a);
      default: return cudaErrorInvalidValue;
    }
  }
  if (path == kGlobal && s == 8) return launch_slices<T, 8, false, false>(a);
  return cudaErrorInvalidValue;
}

bool uses_small_path(int d, int k) { return d <= 8 && k <= Small<8>::KMAX; }

template <typename T>
int launch(const Args& a, int path, int s) {
  if (a.n < 0 || a.d < 1 || a.k < 1 || a.nb < 1 || a.sms < 1) return (int)cudaErrorInvalidValue;
  if (2 * ((int64_t)a.k + 1) * a.d >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  if (uses_small_path(a.d, a.k) != (path == kSmall)) return (int)cudaErrorInvalidValue;
  if (path == kSmall) return a.nb < 2 ? (int)cudaErrorInvalidValue : (int)small_path<T>(a);
  return (int)general_path<T>(a, path, s);
}

}  // namespace

extern "C" {

// x (n, d) row-major f32 or bf16; labels (n,) int32; thr (2, k, d) f32;
// gthr (2, d) f32 or NULL; out (k*2d + 2d, or k*2d without gthr) int32,
// written in full; `path` and `s` the wrapper's plan (ops/seg_count.plan:
// 0 small, 1 rows, 2 pairs, 3 global; s the slice width).  The small path
// takes `part` as nb * (2kd + 2d) int32 block partials and `ticket` as one
// uint32, zero before the first launch; nb >= 2 the partial capacity in
// blocks (2 x SMs).  The rows and pairs paths take `part` as 2kd + 2d
// int32 zeroed and `ticket` as nb >= d / s (rounded up) uint32 zeroed;
// each launch leaves them zero again.  The global path counts into `out`,
// which the caller zeroes.  sms the device's SM count.  Returns a
// cudaError_t code (0 = launched).
int cdrs_seg_count_f32(const void* x, const void* labels, const void* thr, const void* gthr,
                       int64_t n, int d, int k, void* out, void* part, void* ticket, int nb,
                       int sms, int path, int s, void* stream) {
  const Args a{x, (const int*)labels, (const float*)thr, (const float*)gthr, n, d, k,
               (int*)out, (int*)part, (unsigned*)ticket, nb, sms, (cudaStream_t)stream};
  return launch<float>(a, path, s);
}

int cdrs_seg_count_bf16(const void* x, const void* labels, const void* thr, const void* gthr,
                        int64_t n, int d, int k, void* out, void* part, void* ticket, int nb,
                        int sms, int path, int s, void* stream) {
  const Args a{x, (const int*)labels, (const float*)thr, (const float*)gthr, n, d, k,
               (int*)out, (int*)part, (unsigned*)ticket, nb, sms, (cudaStream_t)stream};
  return launch<__nv_bfloat16>(a, path, s);
}

}  // extern "C"
