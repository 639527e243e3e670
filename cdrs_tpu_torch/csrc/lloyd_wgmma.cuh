// B1's general path on Hopper's wgmma, fed by TMA from a producer warp,
// included by lloyd.cu (whose note gives the bound, the split product's
// error and the mma_sync path), with the pieces all its paths share: |c|^2
// in feature order and the TF32 split.
//
// The wgmma path.  One block an SM (persistent; a cooperative launch, so
// its two grid barriers are safe), each taking a contiguous run of 256-row
// tiles of x, the runs within one tile of each other; 384 threads in three
// warpgroups, centroid tiles of kBN = 128:
// - Prologue (every thread).  Every block writes its share of c as the
//   products read it: for each (centroid tile, feature chunk of cb = 32,
//   64 or 128 bytes) a block of 128 rows x cb bytes, K-major and swizzled
//   as shared memory will hold it, so one bulk copy brings it; f32 points
//   are split into TF32 high and low parts here, once, and each k-step's 8
//   features are permuted to the order the x fragments are read in; bf16
//   points are copied exact.  And its share of |c|^2 (feature order), read
//   later from device memory through L1.  Then a grid barrier.
// - The producer warpgroup drops to 40 registers (setmaxnreg); one thread
//   keeps the loads in flight in the order the consumers take them: x
//   tiles by TMA (a 2D tensor map, boxes of 256 rows x cb bytes with the
//   matching swizzle; rows past n and features past d arrive as zeros, so
//   the ragged end needs no mask), and c chunks by bulk copies, either all
//   of c once (resident, when it fits beside 2 to 4 x tiles) or through a
//   ring, each buffer with a full and an empty mbarrier.
// - Two consumer warpgroups (232 registers) take 128 rows of each tile, two
//   m64 blocks.  For each centroid tile, chunk by chunk: f32 points take
//   three wgmma m64n128k8 TF32 products a k-step of 8 features (x_lo.c_hi,
//   x_hi.c_lo, x_hi.c_hi), c's parts by descriptor and x's fragments read
//   from the swizzled tile into registers and split there (A from
//   registers: splitting x into high and low tiles in shared memory would
//   take twice the tile, 256 KB at d = 128); the fragments rotate through
//   three register sets with at most two groups in flight, since a
//   fragment must stay untouched until its products are done.  bf16 points
//   take one m64n128k16 product, both operands by descriptor.  A chunk
//   goes back to the producer once the products that read it are done.
//   Then the tile's accumulators are ranked (|c_j|^2 - 2 dot, strict <
//   over increasing j); at the end of a row tile the four lanes of a row
//   merge by (distance, index), so the first minimum wins, and labels are
//   stored and counted (integer atomics into the block's row of the partial
//   counts: shared memory is the rings').
// - Sums, after the tiles: each block sorts its counted rows by cluster (a
//   stable counting sort into the order scratch) and streams each
//   cluster's rows from x in row order, one writer a (cluster, feature),
//   into its partial: no float atomics, a fixed order.
// - A second grid barrier; every block folds its share of the cells over
//   the block partials in block order.
// Tried and left out, each slower on the card (PERF.md, PR 22): the
// consumer warpgroups issuing their products in turns (ping-pong), ranking
// one m64 block while the other's products run, per-warp sums tables in
// shared memory, 64-centroid tiles, half-width c chunks for f32, four
// register sets.
#pragma once

#include <cuda.h>   // CUtensorMap and its enums (the encoder is reached through the runtime)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "tile.cuh"

namespace lloyd_shared {

using cdrs::to_f;

// |c_j|^2 in feature order, each product rounded before it is added (the
// plain version's order, so both versions rank alike bit for bit); eight
// features are loaded before they are added.
__device__ __forceinline__ float sq_norm(const float* cj, int d) {
  float s = 0.f;
  int f = 0;
  for (; f + 8 <= d; f += 8) {
    float v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = cj[f + q];
#pragma unroll
    for (int q = 0; q < 8; ++q) s = __fadd_rn(s, __fmul_rn(v[q], v[q]));
  }
  for (; f < d; ++f) s = __fadd_rn(s, __fmul_rn(cj[f], cj[f]));
  return s;
}

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(v));
  return u;
}

// v = hi + lo + e, |e| <= 2^-22 |v| (lloyd.cu's source note).
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

}  // namespace lloyd_shared

namespace wg {

using lloyd_shared::sq_norm;
using lloyd_shared::split_tf32;

constexpr int kBM = 256;          // rows a block tile: 128 a consumer warpgroup
constexpr int kBN = 128;          // centroids a tile (the wgmma instructions' N)
constexpr int kThreads = 384;     // a producer warpgroup and two consumer warpgroups
constexpr int kConsumers = 256;
constexpr size_t kSmemMax = 227 * 1024;
// Named barriers (0 is __syncthreads): 1 the consumer warpgroups, 2 every
// thread.
constexpr int kBarConsumers = 1, kBarAll = 2;
// A wait on a barrier that lasts this many cycles (about 20 s) is a fault:
// the kernel traps, so the caller sees a launch failure and the card is
// not held by a spinning grid.
constexpr long long kHangCycles = 1LL << 35;

struct Params {
  const void* x;        // (n, d) row-major: the passes gather its rows
  const float* c;       // (k, d), already rounded to x's type
  int64_t n, n_valid;
  int d, k;
  int* labels;          // labels (or the wrapper's scratch): the sums read them back
  float* part_sums;     // (grid, k*d) block partials
  int* part_counts;     // (grid, k)
  float* sums;          // (k, d)
  float* counts;        // (k,)
  unsigned char* csplit;   // c as the products read it, then |c|^2: written once a launch
  int* order;           // (n,) each block's counted rows sorted by cluster
  unsigned* bar;        // grid barrier word: zero between launches
  int64_t ntiles;        // 256-row tiles of x: block b takes [b ntiles / grid, (b + 1) ntiles / grid)
  int kp, ntc;          // k rounded up to kBN, centroid tiles
  int cb, nfc;          // bytes of a feature chunk's row (the swizzle span), chunks
  int chunk;            // bytes of one (centroid tile, feature chunk) of c: parts x kBN x cb
  int cstages, xstages, resident;
  int off_c, off_bar;
};

// ---- PTX: shared-memory barriers, TMA, wgmma

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Traps once a wait that began at `start` (clock64) has lasted kHangCycles;
// checked every 1024 polls.
__device__ __forceinline__ void hang_guard(unsigned polls, long long& start) {
  if (polls == 1) start = clock64();
  else if ((polls & 1023) == 0 && clock64() - start > kHangCycles) __trap();
}

// Waits for the completion of the barrier's phase of parity `parity` (a
// fresh barrier counts its phase of parity 1 as complete).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_u32(bar);
  long long start = 0;
  for (unsigned polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    hang_guard(polls + 1, start);
  }
}
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
// The barrier every thread meets, from whichever branch (not .aligned: warp
// 0's producer lane comes to it apart from the warp's other lanes).
__device__ __forceinline__ void bar_all() {
  asm volatile("barrier.sync %0, %1;\n" ::"n"(kBarAll), "n"(kThreads) : "memory");
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of the accumulators across
// a wgmma fence or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The descriptor of a K-major operand tile in shared memory whose rows are
// `cb` bytes (32, 64 or 128), swizzled as TMA writes them; the tile starts
// on a 1024-byte boundary.  Eight rows make one 8 x cb block (SBO); one
// k-step (32 bytes) further along the rows is +2 in the start field.
__device__ __forceinline__ uint64_t make_desc(const void* p, int cb) {
  const uint64_t layout = cb == 128 ? 1 : (cb == 64 ? 2 : 3);
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)
       | ((uint64_t)((8 * cb) >> 4) << 32) | (layout << 62);
}

// Byte offset o (row * cb + byte in the row) of a tile swizzled over
// cb-byte rows: its 16-byte unit is XORed with bits 7.. of o.
__device__ __forceinline__ uint32_t swz(uint32_t o, uint32_t mask) {
  return o ^ (((o >> 7) & mask) << 4);
}

// D (64 x 128, f32) (+)= A (64 x 8, TF32 from registers) . B (128 x 8
// K-major, shared memory).
__device__ __forceinline__ void mma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// D (64 x 128, f32) (+)= A (64 x 16, bf16) . B (128 x 16), both K-major in
// shared memory.
__device__ __forceinline__ void mma_bf16(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// A barrier over the whole grid, called by one thread of each block after
// a block-wide barrier.  Block 0 adds 2^31 - (grid - 1) and every other
// block 1, so each barrier flips the word's top bit and leaves its low bits
// as they were: two barriers a launch leave it zero.  The launch is
// cooperative, so every block is resident.
__device__ __forceinline__ void grid_barrier(unsigned* bar) {
  const unsigned add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
  __threadfence();
  const unsigned old = atomicAdd(bar, add);
  long long start = 0;
  for (unsigned polls = 1;; ++polls) {
    unsigned cur;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(cur) : "l"(bar) : "memory");
    if ((old ^ cur) & 0x80000000u) break;
    hang_guard(polls, start);
  }
  __threadfence();
}

// out[e] = the sum over blocks b of part[b * cells + e], in a fixed order,
// by the thread gt of gs (a multiple of 32) across the grid.  Where cells
// are fewer than a quarter of the threads, T = 2..32 neighbouring lanes take
// a cell, each adding a run of blocks in order, and a shuffle tree adds the
// runs in order; else a thread adds a cell's blocks in order.
template <typename V>
__device__ void fold_partials(const V* part, float* out, int64_t cells, int nb, int64_t gt,
                              int64_t gs) {
  int T = 1;
  while (T < 32 && cells * T * 4 <= gs) T <<= 1;
  const int sub = (int)(gt % T), span = (nb + T - 1) / T;
  const int b0 = min(nb, sub * span), b1 = min(nb, b0 + span);
  for (int64_t base = 0; base < cells; base += gs / T) {
    const int64_t e = base + gt / T;
    V v = 0;
    if (e < cells) {
#pragma unroll 16
      for (int b = b0; b < b1; ++b) v += __ldcg(part + (int64_t)b * cells + e);
    }
    for (int o = 1; o < T; o <<= 1) {
      const V ov = __shfl_down_sync(0xffffffffu, v, o);
      if ((sub & (2 * o - 1)) == 0) v += ov;
    }
    if (sub == 0 && e < cells) out[e] = (float)v;
  }
}

// c as the products read it, written by every block for its share before
// the first grid barrier: for each (centroid tile, feature chunk) `chunk`
// bytes, the tile's kBN centroids x cb bytes of features, K-major and
// swizzled as the shared-memory tile will be (so one bulk copy brings it),
// features past d and centroids past k zero; f32 points: the TF32 high
// parts, then the low parts (split once here); bf16 points: the values,
// exact in bf16.  f32 points store each k-step's 8 features permuted
// (feature 2u at position u, 2u + 1 at u + 4), the order in which
// kstep_tf32 reads x, so the products are unchanged.
template <typename T>
__device__ void write_csplit(const Params& p) {
  constexpr int esz = (int)sizeof(T);
  const int per_row = p.cb / esz;
  const uint32_t mask = p.cb / 16 - 1;
  const int64_t total = (int64_t)p.kp * p.nfc * per_row;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t r = e / per_row;   // j * nfc + fc
    const int ff = (int)(e - r * per_row);
    const int j = (int)(r / p.nfc), fc = (int)(r - (int64_t)j * p.nfc);
    const int jt = j / kBN, nn = j - jt * kBN, f = fc * per_row + ff;
    const float v = (j < p.k && f < p.d) ? p.c[(int64_t)j * p.d + f] : 0.f;
    // f32: within each k-step of 8 features, feature 2u goes to position u
    // and 2u + 1 to u + 4, as the x fragments are read (kstep_tf32).
    const int at = esz == 4 ? (ff & ~7) | ((ff & 1) << 2) | ((ff & 7) >> 1) : ff;
    unsigned char* dst = p.csplit + (int64_t)(jt * p.nfc + fc) * p.chunk
                       + swz((uint32_t)(nn * p.cb + at * esz), mask);
    if (esz == 4) {
      uint32_t hi, lo;
      split_tf32(v, hi, lo);
      *reinterpret_cast<uint32_t*>(dst) = hi;
      *reinterpret_cast<uint32_t*>(dst + kBN * p.cb) = lo;
    } else {
      *reinterpret_cast<__nv_bfloat16*>(dst) = __float2bfloat16_rn(v);
    }
  }
}

// f32 points: one k-step (8 features) of a consumer warpgroup's two m64
// blocks, three TF32 products each (x_lo.c_hi, x_hi.c_lo, x_hi.c_hi), its
// x fragments (k-step ks of the swizzled tile xc) read and split into
// register set S; bh and bl describe the step's c high and low parts.  The
// fragment's k positions t and t + 4 (lane t of a quad) take features 2t
// and 2t + 1, one 8-byte load a row (c is stored in the same order).
// Returns with at most kSets - 1 groups in flight, or (drain) one: a
// fragment must stay untouched until its products are done, so kSets sets
// rotate.
constexpr int kSets = 3;
template <int S, int NACC>
__device__ __forceinline__ void kstep_tf32(float (&acc)[2][NACC], uint32_t (&ah)[kSets][2][4],
                                           uint32_t (&al)[kSets][2][4], const unsigned char* xc,
                                           int cb, uint32_t mask, int warp, int lane,
                                           uint64_t bh, uint64_t bl, int ks, int sd, bool drain) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int r0 = 64 * m + 16 * warp + g;
#pragma unroll
    for (int h = 0; h < 2; ++h) {   // rows r0 (registers 0, 2) and r0 + 8 (1, 3)
      const int r = r0 + 8 * h;
      const float2 v = *reinterpret_cast<const float2*>(
          xc + swz((uint32_t)(r * cb + (ks * 8 + 2 * t) * 4), mask));
      split_tf32(v.x, ah[S][m][h], al[S][m][h]);
      split_tf32(v.y, ah[S][m][h + 2], al[S][m][h + 2]);
    }
  }
  wg_fence();
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    mma_tf32(acc[m], al[S][m], bh, sd);
    mma_tf32(acc[m], ah[S][m], bl, 1);
    mma_tf32(acc[m], ah[S][m], bh, 1);
  }
  wg_commit();
  if (drain) wg_wait<1>();
  else wg_wait<kSets - 1>();
}

// Exclusive prefix sums of cnt[0..k) (device memory) into off[0..k), by the NT threads of
// the caller (`tid` in [0, NT)): each sums a contiguous span, the spans'
// totals are scanned by warp shuffles and one warp over the warps'
// totals; `sync` is their barrier and scratch holds NT / 32 ints.
template <int NT, typename Sync>
__device__ void exclusive_scan(const int* cnt, int* off, int k, int* scratch, int tid, Sync sync) {
  const int lane = tid & 31, warp = tid >> 5;
  const int span = (k + NT - 1) / NT, lo = min(k, tid * span), hi = min(k, lo + span);
  int sum = 0;
  for (int j = lo; j < hi; ++j) sum += __ldcg(cnt + j);
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) scratch[warp] = incl;
  sync();
  if (warp == 0) {
    int t = lane < NT / 32 ? scratch[lane] : 0, ti = t;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, ti, o);
      if (lane >= o) ti += v;
    }
    if (lane < NT / 32) scratch[lane] = ti - t;
  }
  sync();
  int run = scratch[warp] + incl - sum;
  for (int j = lo; j < hi; ++j) {
    off[j] = run;
    run += __ldcg(cnt + j);
  }
  sync();
}

// Streams, for sorted_sums, the rows of S = NW x (32 / L) contiguous ranges
// of clusters, one a group of L lanes: stream s takes the clusters whose
// rows start in [s / S, (s + 1) / S) of the block's sorted order (whole
// clusters, so each (cluster, feature) of the partial has one writer).  A
// lane holds one 16-byte unit of a row (4 f32 or 8 bf16 features), L units
// a sweep; a stream's row indices come 32 at a time, a round ahead, and R
// rows are in flight; a cluster's sums are written once its last row is in
// (zeros for an empty one).  Rows are added in the sorted (increasing row)
// order.
template <typename T, int L>
__device__ void stream_sums(const Params& p, const int* s_off, int rows, const int* order,
                            float* my_part, int cw, int lane) {
  constexpr int NW = kConsumers / 32, G = 32 / L, S = NW * G;
  constexpr int EPU = 16 / (int)sizeof(T);            // features a 16-byte unit
  constexpr int R = 32;                              // rows in flight: 128 registers

  const int k = p.k, d = p.d, units = d * (int)sizeof(T) / 16;
  const int g = lane / L, gl = lane % L, sid = cw * G + g;
  auto first = [&](int ss) {
    if (ss == 0) return 0;
    if (ss == S) return k;
    const int target = (int)((int64_t)rows * ss / S);
    int lo = 0, hi = k;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_off[mid] >= target) hi = mid;
      else lo = mid + 1;
    }
    return lo;
  };
  const int jb = first(sid), je = first(sid + 1);
  const int beg = jb < k ? s_off[jb] : rows, end = je < k ? s_off[je] : rows;
  const int span = __reduce_max_sync(0xffffffffu, end - beg);   // the warp's longest stream
  const T* x = (const T*)p.x;
  for (int u0 = 0; u0 < units; u0 += L) {
    const int f = (u0 + gl) * EPU;
    const bool mine = u0 + gl < units;
    int j = jb;
    int cend = j < je ? (j + 1 < k ? s_off[j + 1] : rows) : 0;
    float a[EPU];
#pragma unroll
    for (int e = 0; e < EPU; ++e) a[e] = 0.f;
    // Writes every cluster of the range that ends at or before position pos.
    auto close = [&](int pos) {
      while (j < je && cend <= pos) {
        if (mine) {
          float4* dst = reinterpret_cast<float4*>(my_part + (int64_t)j * d + f);
#pragma unroll
          for (int e = 0; e < EPU; e += 4) dst[e / 4] = make_float4(a[e], a[e + 1], a[e + 2], a[e + 3]);
        }
#pragma unroll
        for (int e = 0; e < EPU; ++e) a[e] = 0.f;
        ++j;
        cend = j + 1 < k ? s_off[j + 1] : rows;
      }
    };
    // A round is 32 rows of each stream: their indices come one round
    // ahead, 32 / L a lane.
    constexpr int IPL = 32 / L;
    int idx[IPL], nidx[IPL];
    auto fetch = [&](int pos, int (&dst)[IPL]) {
#pragma unroll
      for (int u = 0; u < IPL; ++u) {
        const int at = pos + u * L + gl;
        dst[u] = at < end ? __ldcg(order + at) : 0;
      }
    };
    fetch(beg, nidx);
    for (int o = 0; o < span; o += 32) {
      const int pos = beg + o;
#pragma unroll
      for (int u = 0; u < IPL; ++u) idx[u] = nidx[u];
      if (o + 32 < span) fetch(pos + 32, nidx);
      const int nrow = end - pos;   // rows of this stream left (may be <= 0)
#pragma unroll
      for (int q0 = 0; q0 < 32; q0 += R) {
        uint4 v[R];
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const int row = __shfl_sync(0xffffffffu, idx[(q0 + q) / L], (q0 + q) % L, L);
          v[q] = mine && q0 + q < nrow
                     ? __ldcs(reinterpret_cast<const uint4*>(x + (int64_t)row * d + f))
                     : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int q = 0; q < R; ++q)
          if (q0 + q < nrow) {
            close(pos + q0 + q);
            const uint32_t wv[4] = {v[q].x, v[q].y, v[q].z, v[q].w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if constexpr (sizeof(T) == 4) {
                a[e] += __uint_as_float(wv[e]);
              } else {
                const float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wv[e]));
                a[2 * e] += h.x;
                a[2 * e + 1] += h.y;
              }
            }
          }
      }
    }
    close(end);
  }
}

// The sums of a block's counted rows [r0, r1), by the kConsumers threads
// (`ct`), after its tiles.  First a stable counting sort of the rows by
// cluster into order[r0..r1): each warp takes a contiguous segment of the
// rows, counts its labels, takes its offsets from the clusters' (an
// exclusive scan of the block's counts) and places its rows, ranking equal
// labels among 32 rows by __match_any_sync.  Then stream_sums adds each
// cluster's rows in that order, in streams of L lanes sized to the row (L
// 16-byte units).  cnt holds the block's counts (device memory, written by
// this block); smem (from offset 0) takes 9 k + kConsumers / 32 ints.
template <typename T>
__device__ void sorted_sums(const Params& p, unsigned char* smem, const int* cnt, int64_t r0,
                            int64_t r1, float* my_part, int ct) {
  constexpr int NW = kConsumers / 32;
  const int k = p.k;
  const int lane = ct & 31, cw = ct >> 5;
  int* s_pos = (int*)smem;              // [NW][k]: histograms, then next positions
  int* s_off = s_pos + NW * k;          // [k]: the clusters' first positions
  int* s_scan = s_off + k;              // [NW]
  auto sync = [] { bar_sync(kBarConsumers, kConsumers); };
  const int rows = r1 > r0 ? (int)(r1 - r0) : 0;
  const int seg = (rows + NW - 1) / NW;
  const int sb = min(rows, cw * seg), se = min(rows, sb + seg);
  const int* labels = p.labels + r0;
  for (int e = ct; e < NW * k; e += kConsumers) s_pos[e] = 0;
  sync();
  for (int r = sb + lane; r < se; r += 128) {   // four labels in flight a lane
    int lab[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) lab[u] = r + 32 * u < se ? __ldcg(labels + r + 32 * u) : -1;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (lab[u] >= 0) atomicAdd(&s_pos[cw * k + lab[u]], 1);
  }
  exclusive_scan<kConsumers>(cnt, s_off, k, s_scan, ct, sync);
  for (int j = ct; j < k; j += kConsumers) {
    int run = s_off[j];
    for (int w2 = 0; w2 < NW; ++w2) {
      const int h = s_pos[w2 * k + j];
      s_pos[w2 * k + j] = run;
      run += h;
    }
  }
  sync();
  int* my_pos = s_pos + cw * k;
  int* order = p.order + r0;
  constexpr int AHEAD = 4;   // rounds of 32 labels in flight
  int ring[AHEAD];
#pragma unroll
  for (int u = 0; u < AHEAD; ++u) {
    const int r = sb + 32 * u + lane;
    ring[u] = r < se ? __ldcg(labels + r) : -1;
  }
  for (int b = sb; b < se; b += 32 * AHEAD) {
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      const int r = b + 32 * u + lane, lab = ring[u];
      ring[u] = r + 32 * AHEAD < se ? __ldcg(labels + r + 32 * AHEAD) : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, lab);
      if (lab >= 0) order[my_pos[lab] + __popc(peers & ((1u << lane) - 1u))] = (int)(r0 + r);
      __syncwarp();
      if (lab >= 0 && lane == __ffs(peers) - 1) my_pos[lab] += __popc(peers);
      __syncwarp();
    }
  }
  sync();
  const int units = p.d * (int)sizeof(T) / 16;
  if (units > 16) stream_sums<T, 32>(p, s_off, rows, order, my_part, cw, lane);
  else if (units > 8) stream_sums<T, 16>(p, s_off, rows, order, my_part, cw, lane);
  else if (units > 4) stream_sums<T, 8>(p, s_off, rows, order, my_part, cw, lane);
  else stream_sums<T, 4>(p, s_off, rows, order, my_part, cw, lane);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
lloyd_wgmma_kernel(const Params p, const __grid_constant__ CUtensorMap xmap) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int NACC = kBN / 2;   // accumulators a thread holds for one m64 block
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const int tid = threadIdx.x;
  const int d = p.d, k = p.k;
  const int64_t kd = (int64_t)k * d;
  const int xchunk = kBM * p.cb;            // one feature chunk of a row tile
  const int xslot = p.nfc * xchunk;         // one row tile
  uint64_t* x_full = (uint64_t*)(smem + p.off_bar);
  uint64_t* x_empty = x_full + p.xstages * p.nfc;
  uint64_t* c_full = x_empty + p.xstages * p.nfc;
  uint64_t* c_empty = c_full + p.cstages;
  unsigned char* s_c = smem + p.off_c;
  int* g_cnt = p.part_counts + (int64_t)blockIdx.x * k;   // the block's counts (integer atomics)
  float* g_csq = (float*)(p.csplit + (size_t)p.ntc * p.nfc * p.chunk);   // |c|^2, kp floats

  // Prologue, every thread: the block's share of csplit and of |c|^2 (+inf
  // past k), its zeroed counts, the ring's barriers; then the grid barrier
  // after which both are whole.  The ranking reads |c|^2 from device
  // memory (through L1): shared memory is the ring's.
  write_csplit<T>(p);
  for (int j = blockIdx.x * kThreads + tid; j < p.kp; j += gridDim.x * kThreads)
    g_csq[j] = j < k ? sq_norm(p.c + (int64_t)j * d, d) : INFINITY;
  asm volatile("fence.proxy.async.global;\n" ::: "memory");   // for the bulk copies that read it
  for (int j = tid; j < k; j += kThreads) g_cnt[j] = 0;
  if (tid == 0) {
    for (int i = 0; i < p.xstages * p.nfc; ++i) {
      mbar_init(x_full + i, 1);
      mbar_init(x_empty + i, kConsumers / 32);
    }
    for (int i = 0; i < p.cstages; ++i) {
      mbar_init(c_full + i, 1);
      mbar_init(c_empty + i, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) grid_barrier(p.bar);

  const int64_t t0 = (int64_t)blockIdx.x * p.ntiles / gridDim.x;
  const int64_t t1 = ((int64_t)blockIdx.x + 1) * p.ntiles / gridDim.x;
  const int my = t1 > t0 ? (int)(t1 - t0) : 0;

  if (tid < 128) {
    // ---- the producer warpgroup: one thread keeps the loads in flight, in
    // the order the consumers take them; the rest wait at the end.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      if (p.resident) {   // all of c, once
        mbar_expect_tx(c_full, (unsigned)(p.ntc * p.nfc * p.chunk));
        for (int q = 0; q < p.ntc * p.nfc; ++q)
          bulk_load(s_c + (size_t)q * p.chunk, p.csplit + (size_t)q * p.chunk, p.chunk, c_full);
      }
      int64_t q = 0;   // c chunks issued
      for (int i = 0; i < my; ++i) {
        const int slot = i % p.xstages;
        const unsigned use = (unsigned)(i / p.xstages) & 1u;
        const int row0 = (int)((t0 + i) * kBM);
        for (int jt = 0; jt < (p.resident ? 1 : p.ntc); ++jt) {
          for (int fc = 0; fc < p.nfc; ++fc) {
            if (jt == 0) {   // the tile's x chunk just before its first c chunk
              uint64_t* full = x_full + slot * p.nfc + fc;
              mbar_wait(x_empty + slot * p.nfc + fc, use ^ 1u);
              mbar_expect_tx(full, (unsigned)xchunk);
              tma_load_2d(smem + (size_t)slot * xslot + (size_t)fc * xchunk, &xmap,
                          fc * (p.cb / (int)sizeof(T)), row0, full);
            }
            if (!p.resident) {
              const int s = (int)(q % p.cstages);
              mbar_wait(c_empty + s, ((unsigned)(q / p.cstages) & 1u) ^ 1u);
              mbar_expect_tx(c_full + s, (unsigned)p.chunk);
              bulk_load(s_c + (size_t)s * p.chunk,
                        p.csplit + (size_t)(jt * p.nfc + fc) * p.chunk, p.chunk, c_full + s);
              ++q;
            }
          }
        }
      }
    }
    bar_all();                       // the consumers' partials are written
    if (tid == 0) grid_barrier(p.bar);
    bar_all();
    return;
  }

  // ---- the consumer warpgroups: w takes rows [128 w, 128 w + 128) of each
  // row tile, two m64 blocks.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int ct = tid - 128;
  const int w = ct >> 7, wt = ct & 127;
  const int warp = wt >> 5, lane = wt & 31, g = lane >> 2, t = lane & 3;
  const uint32_t mask = p.cb / 16 - 1;
  const int row_bytes = d * (int)sizeof(T);
  float acc[2][NACC];
  float bv[4];
  int bj[4];
  if (p.resident) mbar_wait(c_full, 0);

  // Ranks m64 block m's products with centroid tile jt: |c_j|^2 - 2 dot, a
  // running best for each of the thread's two rows of the block, strict <
  // over increasing j.  f32 points first take the least distance of the
  // thread's columns and look for its first column only where it beats
  // the best so far (about 2% faster at 1M x 128, k = 1024; bf16 was not).
  auto rank = [&](int m, int jt) {
    if constexpr (F32) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 2 * m + h;
        float lo = INFINITY;
#pragma unroll
        for (int nt = 0; nt < kBN / 8; ++nt) {
          const float2 cs = *reinterpret_cast<const float2*>(g_csq + jt * kBN + nt * 8 + 2 * t);
          lo = fminf(lo, fminf(cs.x - 2.f * acc[m][4 * nt + 2 * h],
                               cs.y - 2.f * acc[m][4 * nt + 2 * h + 1]));
        }
        if (lo < bv[r]) {
          int at = 0;
#pragma unroll
          for (int nt = kBN / 8 - 1; nt >= 0; --nt) {   // the last match seen is the first column
            const int j = jt * kBN + nt * 8 + 2 * t;
            const float2 cs = *reinterpret_cast<const float2*>(g_csq + j);
            if (cs.y - 2.f * acc[m][4 * nt + 2 * h + 1] == lo) at = j + 1;
            if (cs.x - 2.f * acc[m][4 * nt + 2 * h] == lo) at = j;
          }
          bv[r] = lo;
          bj[r] = at;
        }
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < kBN / 8; ++nt) {
        const int j = jt * kBN + nt * 8 + 2 * t;
        const float2 cs = *reinterpret_cast<const float2*>(g_csq + j);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 2 * m + h;
          const float v0 = cs.x - 2.f * acc[m][4 * nt + 2 * h];
          const float v1 = cs.y - 2.f * acc[m][4 * nt + 2 * h + 1];
          if (v0 < bv[r]) { bv[r] = v0; bj[r] = j; }
          if (v1 < bv[r]) { bv[r] = v1; bj[r] = j + 1; }
        }
      }
    }
  };
  // Row tile i's labels: merge the four lanes of a row by (distance,
  // index), so the lower index wins equal distances; store and count; then
  // start the next tile's running bests.
  auto finish = [&](int i) {
    const int64_t base = (t0 + i) * kBM + w * 128;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float v = bv[r];
      int j = bj[r];
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, o);
        const int oj = __shfl_xor_sync(0xffffffffu, j, o);
        if (ov < v || (ov == v && oj < j)) { v = ov; j = oj; }
      }
      if (t == 0) {
        const int rr = 64 * (r >> 1) + 16 * warp + 8 * (r & 1) + g;
        const int64_t row = base + rr;
        if (row < p.n) p.labels[row] = j;
        if (row < p.n_valid) atomicAdd(&g_cnt[j], 1);
      }
      bv[r] = INFINITY;
      bj[r] = 0;
    }
  };
  // Waits until x chunk fc of row tile i is in, and the q-th c chunk the
  // ring has taken (none when resident).
  auto x_in = [&](int i, int fc) {
    mbar_wait(x_full + (i % p.xstages) * p.nfc + fc, (unsigned)(i / p.xstages) & 1u);
  };
  auto c_in = [&](int64_t q) {
    if (!p.resident) mbar_wait(c_full + (int)(q % p.cstages), (unsigned)(q / p.cstages) & 1u);
  };
  auto c_chunk = [&](int jt, int fc, int64_t q) -> const unsigned char* {
    return p.resident ? s_c + (size_t)(jt * p.nfc + fc) * p.chunk
                      : s_c + (size_t)((q + fc) % p.cstages) * p.chunk;
  };
  auto x_chunk = [&](int i, int fc) -> const unsigned char* {
    return smem + (size_t)(i % p.xstages) * xslot + (size_t)fc * xchunk + (size_t)w * 128 * p.cb;
  };
  auto k_steps = [&](int fc) {   // 32-byte k-steps of chunk fc (the last one may be short)
    const int left = row_bytes - fc * p.cb;
    return ((left < p.cb ? left : p.cb) + 31) / 32;
  };
  // Gives back, once the products that read it are done, the q-th c chunk
  // (unless resident), and x chunk fc of row tile i after its last centroid
  // tile.
  auto release_c = [&](int64_t q) {
    if (lane == 0 && !p.resident) mbar_arrive(c_empty + (int)(q % p.cstages));
  };
  auto release_x = [&](int i, int jt, int fc) {
    if (lane == 0 && jt == p.ntc - 1) mbar_arrive(x_empty + (i % p.xstages) * p.nfc + fc);
  };
  for (int r = 0; r < 4; ++r) { bv[r] = INFINITY; bj[r] = 0; }
  const int64_t steps = (int64_t)my * p.ntc;   // (row tile, centroid tile) pairs

  // Each (row tile, centroid tile): its products k-step by k-step, each c
  // and x chunk given back once the products that read it are done; then
  // both m64 blocks are ranked.
  uint32_t ah[kSets][2][4], al[kSets][2][4];   // f32 points: [set][m64 block][fragment register]
  int64_t q = 0;                       // c chunks taken (streamed)
  for (int64_t sidx = 0; sidx < steps; ++sidx, q += p.nfc) {
    const int i = (int)(sidx / p.ntc), jt = (int)(sidx % p.ntc);
    if constexpr (F32) {
      // Three TF32 products a k-step of 8 features; up to kSets k-steps in
      // flight, their fragments in kSets register sets.  The first step of
      // a chunk waits until the last chunk's products are done and gives
      // that chunk back.
      int step = 0;
      for (int fc = 0; fc < p.nfc; ++fc) {
        if (jt == 0) x_in(i, fc);
        c_in(q + fc);
        const unsigned char* xc = x_chunk(i, fc);
        const unsigned char* cc = c_chunk(jt, fc, q);
        const uint64_t bh = make_desc(cc, p.cb), bl = make_desc(cc + kBN * p.cb, p.cb);
        const int nks = k_steps(fc);
        for (int ks = 0; ks < nks; ++ks, ++step) {
          const int sd = (fc == 0 && ks == 0) ? 0 : 1, set = step % kSets;
          const uint64_t h = bh + 2 * ks, l = bl + 2 * ks;
          // The first step of a chunk drains all but itself, so the last
          // chunk can go back.
          const bool drain = ks == 0 && fc > 0;
          switch (set) {
            case 0: kstep_tf32<0, NACC>(acc, ah, al, xc, p.cb, mask, warp, lane, h, l, ks, sd, drain); break;
            case 1: kstep_tf32<1, NACC>(acc, ah, al, xc, p.cb, mask, warp, lane, h, l, ks, sd, drain); break;
            default: kstep_tf32<2, NACC>(acc, ah, al, xc, p.cb, mask, warp, lane, h, l, ks, sd, drain);
          }
          if (drain) {
            release_c(q + fc - 1);
            release_x(i, jt, fc - 1);
          }
        }
      }
      wg_wait<0>();
      release_c(q + p.nfc - 1);
    } else {
      // One exact bf16 product a k-step of 16 features, a group a chunk.
      for (int fc = 0; fc < p.nfc; ++fc) {
        if (jt == 0) x_in(i, fc);
        c_in(q + fc);
        const unsigned char* xc = x_chunk(i, fc);
        const uint64_t b = make_desc(c_chunk(jt, fc, q), p.cb), a0 = make_desc(xc, p.cb),
                       a1 = make_desc(xc + 64 * p.cb, p.cb);
        wg_fence();
        const int nks = k_steps(fc);
        for (int ks = 0; ks < nks; ++ks) {
          const int sd = (fc == 0 && ks == 0) ? 0 : 1;
          mma_bf16(acc[0], a0 + 2 * ks, b + 2 * ks, sd);
          mma_bf16(acc[1], a1 + 2 * ks, b + 2 * ks, sd);
        }
        wg_commit();
        if (fc > 0) {
          wg_wait<1>();
          release_c(q + fc - 1);
          release_x(i, jt, fc - 1);
        }
      }
      wg_wait<0>();
      release_c(q + p.nfc - 1);
    }
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    release_x(i, jt, p.nfc - 1);
    rank(0, jt);
    rank(1, jt);
    if (jt == p.ntc - 1) finish(i);
  }

  // The block's partial, written once: its counted rows sorted by cluster
  // and summed.
  bar_sync(kBarConsumers, kConsumers);
  const int64_t r1 = t1 * kBM < p.n_valid ? t1 * kBM : p.n_valid;
  sorted_sums<T>(p, smem, g_cnt, t0 * kBM, r1, p.part_sums + (int64_t)blockIdx.x * kd, ct);
  bar_all();
  bar_all();   // thread 0 has passed the grid barrier: every partial is written

  // Every block sums its share of the cells over the partials.
  const int64_t gt = (int64_t)blockIdx.x * kConsumers + ct, gs = (int64_t)gridDim.x * kConsumers;
  fold_partials(p.part_sums, p.sums, kd, gridDim.x, gt, gs);
  fold_partials(p.part_counts, p.counts, (int64_t)k, gridDim.x, gt, gs);
}

// ---- host side

// A plan of this path, as ops/lloyd.py's plan() makes it.
struct Cfg {
  int cstages, xstages, resident;
};

// The plan's shared-memory layout for (d, k) points of esz bytes: the x
// ring (xstages row tiles of nfc chunks of kBM x cb bytes) from offset 0,
// then c (resident: every chunk; else a ring of cstages), the barriers,
// and 1024 bytes to align the base.  False when rows are
// not a multiple of 16 bytes (TMA's row stride), the plan does not fit, or
// the freed tiles cannot hold the sums' sort (9 k + kConsumers ints).
inline bool layout(int d, int k, int esz, const Cfg& c, Params& p, size_t& smem) {
  const int row = d * esz;
  if (d < 1 || k < 1 || row % 16 != 0 || c.xstages < 1
      || (!c.resident && c.cstages < 2))
    return false;
  p.cb = row > 64 ? 128 : (row > 32 ? 64 : 32);
  p.nfc = (row + p.cb - 1) / p.cb;
  p.kp = (k + kBN - 1) / kBN * kBN;
  p.ntc = p.kp / kBN;
  p.chunk = (esz == 4 ? 2 : 1) * kBN * p.cb;
  p.cstages = c.resident ? 1 : c.cstages;
  p.xstages = c.xstages;
  p.resident = c.resident;
  const size_t xslot = (size_t)kBM * p.cb * p.nfc;
  const size_t cbuf = c.resident ? (size_t)p.ntc * p.nfc * p.chunk : (size_t)p.cstages * p.chunk;
  p.off_c = (int)(p.xstages * xslot);
  p.off_bar = (int)(p.off_c + cbuf);
  smem = (size_t)p.off_bar + (size_t)(2 * p.xstages * p.nfc + 2 * p.cstages) * 8 + 1024;
  // The sums' sort takes its histograms, offsets and scan in the freed tiles.
  return smem <= kSmemMax && (size_t)(9 * k + kConsumers) * 4 <= (size_t)p.off_bar;
}

}  // namespace wg
