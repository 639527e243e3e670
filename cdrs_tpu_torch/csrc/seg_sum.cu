// Per-cluster float sums on Hopper (sm_90a):
//
//   out[j, f] = sum over { i : lab_i = j } of y[i, f]      (j < k, f < d)
//
// for y (n, d) row-major in f32 or bf16, accumulated in f32; labels < 0 or
// >= k add nothing.  Replaces the TPU kernel label_segment_matmul
// (cdrs_tpu/ops/pallas_kernels.py:534, _kernel_seg / _build_seg), which takes
// the same sums as a one-hot product on the MXU, tile by tile.
//
// Deterministic: no float atomics.  The same inputs give the same bits on
// every launch (on one card: the grid follows the SM count).
//
// What bounds it on this card: y and the labels are read once and each
// element is added once, so its bound is the read.  Each feature slice
// re-reads the labels only; the block tables and their fold add about 6%
// to the bytes at 1M x 128, k = 1024, and more than twice y's at 1M x 4,
// k = 20,000.  What sets its pace is the adds (tools/segsum_breakdown.py:
// the staging alone runs near the bound).
//
// * Tiles.  The (k, d) table is cut into slices of `s` features and, where
//   even one feature of every cluster would not fit in shared memory, slabs
//   of `ns` clusters (the wrapper's plan, ops/seg_sum.plan, picks both so
//   that a block's table fits beside its staging ring).  Block b takes tile
//   b % tiles over the rows of group b / tiles: the blocks of one group
//   read the same rows at once, each its own slice of them.
// * Rows.  A block stages chunks of `rows` rows of its slice, and their
//   labels, into a ring of kStages buffers with cp.async (16-, 8- or 4-byte
//   copies, the widest that divides every offset; 2-byte loads for bf16
//   rows of odd width), two chunks in flight while it adds the third.
// * Adds (add_rows).  Cluster s0 + j of the slab belongs to warp j % kWarps and
//   feature f of the slice (at most 32) to lane f: one writer a cell of the
//   block's table, which adds its rows in increasing order.  A chunk costs
//   each warp one ballot for every 32 rows, which lists its rows; it then
//   adds them eight at a time, keeping its last cell in registers, so a run
//   of rows of one cluster costs one load and one store of its cells.  A
//   cluster that holds most rows still puts most of the work on one warp:
//   slower, never wrong.
// * Fold.  Each block writes its table to `part`; a second launch sums the
//   partials of every cell over the groups in group order (a thread a cell,
//   or a warp a cell where the cells are few and the groups many), and
//   writes the output in full (no memset).
// * Offsets into y are 64-bit: n * d may pass 2^31.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tile.cuh"

namespace {

using cdrs::kStages;
using cdrs::to_f;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kFoldThreads = 256;
constexpr int kBatch = 8;   // rows a warp fetches before it adds them
constexpr int kChunkRows = 256;   // rows a chunk at most (a list entry keeps 8 bits of row)
constexpr int kSliceMax = 32;     // features a slice at most: a lane each
// The fold gives a warp to each cell (lanes take every 32nd group, then a
// fixed shuffle tree) where the cells are few and the groups many: at most
// this many cells, and more groups than lanes.
constexpr int64_t kWarpFoldCells = 4096;
constexpr unsigned kFull = 0xffffffffu;
// A block's dynamic shared memory may not pass this (ops/seg_sum.SMEM_MAX:
// the H100's 227 KB a block less room for the static arrays).
constexpr size_t kSmemMax = 232448 - 1024;

__host__ __device__ inline int r16(int64_t b) { return (int)((b + 15) & ~(int64_t)15); }

// The shared-memory layout, as ops/seg_sum._smem counts it: the table of
// ns * s floats, then kStages buffers of `rows` staged row slices and their
// labels, each part rounded up to 16 bytes, then each warp's list of its
// rows of a chunk (`rows` ints).
struct Layout {
  int table, row_bytes, buf, lists;
  __host__ __device__ Layout(int s, int ns, int rows, int esz)
      : table(r16((int64_t)ns * s * 4)), row_bytes(r16((int64_t)rows * s * esz)),
        buf(r16((int64_t)rows * s * esz) + r16((int64_t)rows * 4)),
        lists(kWarps * rows * 4) {}
  __host__ __device__ size_t bytes() const {
    return (size_t)table + (size_t)kStages * buf + (size_t)lists;
  }
};

struct Args {
  const void* y;
  const int* lab;
  int64_t n;
  int d, k;
  int s, ns, rows, groups;
  int64_t group_rows;
  float* part;   // (tiles, groups, ns * s) block tables
  float* out;    // (k, d)
  cudaStream_t stream;
};

// Starts the copy of `unit` bytes (16, 8 or 4: cp.async; 2: a plain load
// and store, complete at once).
__device__ __forceinline__ void copy_unit(unsigned char* dst, const unsigned char* src, int unit) {
  if (unit == 16) cdrs::cp_async16(dst, src, 16);
  else if (unit == 8) cdrs::cp_async8(dst, src);
  else if (unit == 4) cdrs::cp_async4(dst, src);
  else *reinterpret_cast<uint16_t*>(dst) = *reinterpret_cast<const uint16_t*>(src);
}

// Adds the m staged rows (`ys`, s <= 32 elements apart; labels `lab`) whose
// cluster falls in the slab [s0, s0 + h) into acc[(j - s0) * s + f], f < w.
// Cluster j belongs to warp (j - s0) % kWarps and feature f to lane f: one
// writer a cell, rows in increasing order, so the same inputs give the same
// bits.  The warp first lists its rows of the chunk in order (one ballot a
// 32 rows; an entry holds the cluster and the row), then takes them kBatch
// at a time.  Its open cell (cluster cj, the lane's running sum t) stays in
// registers across rows, batches and chunks, and goes to shared memory only
// when a row of another cluster comes: t = acc; t += v0; t += v1; ... gives
// the bits of adding the rows into the cell one by one.  The values of a
// batch are loaded together before the adds.
template <typename T>
__device__ __forceinline__ void add_rows(float* acc, const int* lab, const T* ys, int* list, int m,
                                         int s0, int h, int s, int w, int& cj, float& t) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int cnt = 0;
  for (int r0 = 0; r0 < m; r0 += 32) {
    const int r = r0 + lane;
    const int j = r < m ? lab[r] : -1;
    const bool own = j >= s0 && j - s0 < h && (j - s0) % kWarps == warp;
    const unsigned mask = __ballot_sync(kFull, own);
    if (own) list[cnt + __popc(mask & ((1u << lane) - 1u))] = ((j - s0) << 8) | r;
    cnt += __popc(mask);
  }
  __syncwarp();
  const bool live = lane < w;
  for (int i = 0; i < cnt; i += kBatch) {
    int jr[kBatch];
    float v[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int e = i + q < cnt ? list[i + q] : -1;
      jr[q] = e < 0 ? -1 : e >> 8;
      v[q] = e >= 0 && live ? to_f(ys[(e & 255) * s + lane]) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      if (jr[q] < 0) break;
      if (jr[q] != cj) {
        if (cj >= 0 && live) acc[cj * s + lane] = t;
        cj = jr[q];
        t = live ? acc[cj * s + lane] : 0.f;
      }
      t += v[q];
    }
  }
  __syncwarp();   // the next chunk rewrites the list
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
seg_sum_kernel(const T* __restrict__ y, const int* __restrict__ lab, int64_t n, int d, int k,
               int s, int ns, int rows, int64_t group_rows, int unit, float* __restrict__ part) {
  constexpr int esz = (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(s, ns, rows, esz);
  float* acc = (float*)smem;
  unsigned char* ring = smem + L.table;
  int* list = (int*)(ring + kStages * L.buf) + (threadIdx.x >> 5) * rows;

  const int tid = threadIdx.x;
  const int nslices = (d + s - 1) / s, nslabs = (k + ns - 1) / ns;
  const int tiles = nslices * nslabs;
  const int tile = blockIdx.x % tiles;
  const int64_t grp = blockIdx.x / tiles;
  const int s0 = (tile / nslices) * ns, col0 = (tile % nslices) * s;
  const int h = k - s0 < ns ? k - s0 : ns;    // this slab's clusters
  const int w = d - col0 < s ? d - col0 : s;  // this slice's features
  const int cells = ns * s;
  for (int e = tid; e < cells; e += kThreads) acc[e] = 0.f;

  const int64_t r_begin = grp * group_rows;
  const int64_t r_end = r_begin + group_rows < n ? r_begin + group_rows : n;
  const int64_t here = r_end > r_begin ? r_end - r_begin : 0;
  const int chunks = (int)((here + rows - 1) / rows);
  const int per = w * esz / unit;   // copies a staged row
  const unsigned char* yb = (const unsigned char*)y;
  auto issue = [&](int i) {
    if (i < chunks) {
      const int64_t r0 = r_begin + (int64_t)i * rows;
      const int m = r_end - r0 < rows ? (int)(r_end - r0) : rows;
      unsigned char* dst = ring + (i % kStages) * L.buf;
      const unsigned char* src = yb + (r0 * d + col0) * esz;
      for (int q = tid; q < m * per; q += kThreads) {
        const int r = q / per, p = q - r * per;
        copy_unit(dst + r * s * esz + p * unit, src + (int64_t)r * d * esz + p * unit, unit);
      }
      for (int r = tid; r < m; r += kThreads)
        cdrs::cp_async4(dst + L.row_bytes + 4 * r, lab + r0 + r);
    }
    cdrs::cp_async_commit();
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) issue(st);

  int cj = -1;    // this warp's open cell: its cluster in the slab (-1: none)
  float t = 0.f;  // and the lane's running sum of it
  for (int i = 0; i < chunks; ++i) {
    cdrs::cp_async_wait<kStages - 2>();
    __syncthreads();            // chunk i is in; every warp is done with chunk i - 1
    issue(i + kStages - 1);     // into chunk i - 1's buffer
    const unsigned char* b = ring + (i % kStages) * L.buf;
    const int64_t r0 = r_begin + (int64_t)i * rows;
    const int m = r_end - r0 < rows ? (int)(r_end - r0) : rows;
    add_rows<T>(acc, (const int*)(b + L.row_bytes), (const T*)b, list, m, s0, h, s, w, cj, t);
  }
  cdrs::cp_async_wait<0>();
  if (cj >= 0 && (tid & 31) < w) acc[cj * s + (tid & 31)] = t;
  __syncthreads();
  float* dst = part + ((int64_t)tile * (gridDim.x / tiles) + grp) * cells;
  for (int e = tid; e < cells; e += kThreads) dst[e] = acc[e];
}

// out[j, f] = the sum over groups, in group order, of the partials of the
// cell (j, f) of its tile: one thread a cell (L = 1), or one warp a cell
// (L = 32), whose lane l adds groups l, l + 32, ... in order before a fixed
// shuffle tree.
template <int L>
__global__ void __launch_bounds__(kFoldThreads)
seg_sum_fold(const float* __restrict__ part, float* __restrict__ out, int d, int k, int s, int ns,
             int groups) {
  const int nslices = (d + s - 1) / s;
  const int64_t cells = (int64_t)ns * s;
  const int64_t c = ((int64_t)blockIdx.x * kFoldThreads + threadIdx.x) / L;
  const int l = threadIdx.x % L;
  const int64_t tiles = (int64_t)nslices * ((k + ns - 1) / ns);
  if (c >= tiles * cells) return;   // whole warps when L = 32
  const int64_t tile = c / cells;
  const int e = (int)(c - tile * cells);
  const int j = (int)(tile / nslices) * ns + e / s, f = (int)(tile % nslices) * s + e % s;
  if (j >= k || f >= d) return;
  const float* p = part + tile * groups * cells + e;
  float v = 0.f;
  for (int g = l; g < groups; g += L) v += __ldg(p + (int64_t)g * cells);
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  if (l == 0) out[(int64_t)j * d + f] = v;
}

// Raises the kernel's dynamic shared-memory limit to `smem` once per device.
template <typename T>
cudaError_t allow_smem(size_t smem) {
  static size_t smem_set[32] = {};
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  return cdrs::set_smem_once(seg_sum_kernel<T>, smem, smem_set);
}

template <typename T>
cudaError_t blocks_per_sm(int s, int ns, int rows, int* blocks) {
  const size_t smem = Layout(s, ns, rows, (int)sizeof(T)).bytes();
  cudaError_t err = allow_smem<T>(smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, seg_sum_kernel<T>, kThreads, smem);
}

template <typename T>
int launch(const Args& a) {
  const int esz = (int)sizeof(T);
  if (a.n < 0 || a.d < 1 || a.k < 1 || a.s < 1 || a.s > a.d || a.s > kSliceMax || a.ns < 1 ||
      a.ns > a.k || a.ns >= (1 << 23) || a.rows < 1 || a.rows > kChunkRows || a.groups < 1 ||
      a.group_rows < 1 || (int64_t)a.k * a.d >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  if ((int64_t)a.groups * a.group_rows < a.n) return (int)cudaErrorInvalidValue;
  const int nslices = (a.d + a.s - 1) / a.s;
  const int64_t tiles = (int64_t)nslices * ((a.k + a.ns - 1) / a.ns);
  const int64_t grid = tiles * a.groups;
  const int64_t cells = tiles * a.ns * a.s;
  if (grid >= ((int64_t)1 << 31) || (int64_t)a.ns * a.s >= ((int64_t)1 << 31) ||
      (cells + kFoldThreads - 1) / kFoldThreads >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  const size_t smem = Layout(a.s, a.ns, a.rows, esz).bytes();
  cudaError_t err = allow_smem<T>(smem);
  if (err != cudaSuccess) return (int)err;
  // The widest copy that divides every offset: the row pitch, the slice
  // widths (the last may be narrower) and y's own alignment.
  const uint64_t wlast = (uint64_t)(a.d - (nslices - 1) * a.s);
  const uint64_t bits = (uint64_t)a.d * esz | (uint64_t)a.s * esz | wlast * esz |
                        ((uintptr_t)a.y & 15) | 16u;
  const int unit = (int)(bits & (~bits + 1));
  if (unit < 2) return (int)cudaErrorMisalignedAddress;
  seg_sum_kernel<T><<<(unsigned)grid, kThreads, smem, a.stream>>>(
      (const T*)a.y, a.lab, a.n, a.d, a.k, a.s, a.ns, a.rows, a.group_rows, unit, a.part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (cells <= kWarpFoldCells && a.groups > 32)
    seg_sum_fold<32><<<(unsigned)((cells * 32 + kFoldThreads - 1) / kFoldThreads), kFoldThreads,
                       0, a.stream>>>(a.part, a.out, a.d, a.k, a.s, a.ns, a.groups);
  else
    seg_sum_fold<1><<<(unsigned)((cells + kFoldThreads - 1) / kFoldThreads), kFoldThreads, 0,
                      a.stream>>>(a.part, a.out, a.d, a.k, a.s, a.ns, a.groups);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Resident blocks an SM of the kernel at the plan (s, ns, rows), for y in
// bf16 (bf16 != 0) or f32, into *blocks; also raises the kernel's dynamic
// shared-memory limit on the current device.  Returns a cudaError_t code.
int cdrs_seg_sum_blocks_per_sm(int bf16, int s, int ns, int rows, int* blocks) {
  if (s < 1 || s > kSliceMax || ns < 1 || rows < 1 || rows > kChunkRows)
    return (int)cudaErrorInvalidValue;
  return (int)(bf16 ? blocks_per_sm<__nv_bfloat16>(s, ns, rows, blocks)
                    : blocks_per_sm<float>(s, ns, rows, blocks));
}

// y (n, d) row-major f32 or bf16; lab (n,) int32; out (k, d) f32, written
// in full.  The plan (ops/seg_sum.plan): slices of s features, slabs of ns
// clusters, chunks of `rows` rows; `groups` row groups of group_rows rows
// (groups * group_rows >= n).  part holds tiles * groups * ns * s floats
// (tiles = ceil(d / s) * ceil(k / ns)); nothing in it is read before it is
// written.  Two launches on `stream`: the block tables, then their fold.
// Returns a cudaError_t code (0 = launched).
int cdrs_seg_sum_f32(const void* y, const void* lab, int64_t n, int d, int k, int s, int ns,
                     int rows, int groups, int64_t group_rows, void* part, void* out,
                     void* stream) {
  const Args a{y, (const int*)lab, n, d, k, s, ns, rows, groups, group_rows, (float*)part,
               (float*)out, (cudaStream_t)stream};
  return launch<float>(a);
}

int cdrs_seg_sum_bf16(const void* y, const void* lab, int64_t n, int d, int k, int s, int ns,
                      int rows, int groups, int64_t group_rows, void* part, void* out,
                      void* stream) {
  const Args a{y, (const int*)lab, n, d, k, s, ns, rows, groups, group_rows, (float*)part,
               (float*)out, (cudaStream_t)stream};
  return launch<__nv_bfloat16>(a);
}

}  // extern "C"
